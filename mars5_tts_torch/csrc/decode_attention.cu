// One decode token's attention over the ring KV cache for Hopper (sm_90a):
// kernel K7 decode_attention.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/decode_attention.py::
// _make_kernel (entry decode_attention_pallas): for row b at position pos[b],
// ring slot s holds position pos - ((pos - s) mod W); negative positions are
// masked, and in self-column mode (k_new / v_new given) so is the current
// token's stale slot pos mod W, the token attending to itself through one
// extra column. Scores are f32 and scaled by 1/sqrt(D); softmax over the
// valid slots and the self column; the ring's probabilities are rounded to
// the cache dtype before the PV product, the self column's stay f32.
//
// What bounds it: bytes, the K and V rows of the valid slots (3 KB a slot and
// layer at 24 heads of 64 in bf16), against ~128 flops a slot and head: at
// pos 1900 one row's call must move 11.7 MB, 3.5 us at the H100 SXM's
// data-sheet 3.35 TB/s (700 W). One block a (head, row) would leave 24 blocks
// on 132 SMs at batch 1, each walking up to 2,001 slots alone: latency, not
// bandwidth, would set the time.
//
// The design: each (head, row) gets a thread-block cluster of C CTAs (1-8;
// the wrapper's cluster_size: one CTA per 256 valid slots of the host's
// bound on them, and no more than keeps a call near 300 CTAs, two on each SM
// of an H100). CTA r takes slots [r per, (r + 1) per) of the row's
// n = min(pos + 1, W) valid ones, per = ceil(n / C). Scores and PV both run
// 8 lanes a slot (16 bytes of the K or V row each, q's 8 values a lane in
// registers, the slot's partial dot summed over its lanes by shuffles), with
// the rows of 4 slots loaded before any is used, so a lane has 4 loads in
// flight; V rows whose probability is 0 are not read. The twin rounds
// p / denom to the cache dtype with the row's global max and global
// denominator before PV; a flash-decoding split (per-split maxima, rescaled
// afterwards) cannot round the same way. So the CTAs exchange three
// reductions through distributed shared memory, each behind a cluster
// barrier: (1) the max, (2) the f64 exp sums, (3) the f64 PV partials,
// pushed into rank 0. Lane r of every warp reads rank r's max and sum, and
// one warp reduction in a fixed order gives every CTA the same m and
// denominator, so every CTA rounds p exactly as the twin does. q, k_new and
// v_new are read before the position, which the ring addresses wait for.
// Registers are capped at 128 a thread (2 CTAs an SM). At batch 1 and the
// released widths (24 heads, a 2,001-slot ring) a late step runs 8 CTAs a
// head, 192 CTAs in place of 24; four rows run 3 a (head, row), 288 CTAs.
//
// Numerics: the q . k dots, the softmax denominator and the PV sums
// accumulate in f64 (every product of two f32 or bf16 values is exact there;
// the sums, taken in other orders than the twin's, round far below an f32
// ulp) and round to f32 once, as the plain twin decode_attention_ref does;
// the rest is the same f32 ops: s = (float)dot * scale, p = expf(s - m),
// prob = p / denom (true division), out = (float)PV + (p_self / denom) * v.
//
// The C entry launches with cudaLaunchKernelEx (the cluster size is a launch
// attribute) and returns its error, or cudaGetLastError() after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "warp_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mars5;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kLanes = 8;                         // lanes sharing one slot's K or V row
constexpr int kCols = kHeadDim / kLanes;          // columns a lane takes (16 bytes of bf16)
constexpr int kGroups = kThreads / kLanes;        // slots a pass takes
constexpr int kUnroll = 4;                        // passes whose rows are loaded together
constexpr int kMaxWindow = 8192;
constexpr int kMaxCluster = 8;                    // the portable cluster size
constexpr int kCtasPerSm = 2;                     // registers capped at 128 a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n elements of T loaded from p (16-byte aligned) in 16-byte loads, kept in
// registers as whole 16-byte words.
template <typename T, int n>
struct Vec {
  static_assert(n * sizeof(T) % 16 == 0, "whole 16-byte loads");
  uint4 raw[n * sizeof(T) / 16];
  __device__ __forceinline__ float operator[](int i) const {
    return to_f(reinterpret_cast<const T*>(raw)[i]);
  }
};
template <typename T, int n>
__device__ __forceinline__ Vec<T, n> load_vec(const T* p) {
  Vec<T, n> r;
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < n * (int)sizeof(T) / 16; ++i) r.raw[i] = s[i];
  return r;
}

__device__ __forceinline__ float block_max_f(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ double block_sum_d(double v, double* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r += red[i];
  return r;
}

struct Args {
  const void* q;      // (B, H, 64)
  const void* k;      // (B, W, H, 64)
  const void* v;
  const void* k_new;  // (B, H, 64) or null
  const void* v_new;
  const int* pos;     // (B,)
  void* out;          // (B, H, 64)
  int W, H;
  float scale;
};

// grid (C, H, B) in clusters of (C, 1, 1); dynamic shared memory: ceil(W / C)
// floats (this CTA's scores, then probabilities)
template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) decode_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  __shared__ double qd[kHeadDim];
  __shared__ float kn_s[kHeadDim];
  __shared__ float red[kWarps];
  __shared__ double dred[kWarps];
  __shared__ double pv[kWarps][kHeadDim];
  __shared__ double pv_all[kMaxCluster][kHeadDim];  // rank 0: every CTA's PV partial
  __shared__ float cta_max;
  __shared__ double cta_sum;
  __shared__ float self_sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = p.H, W = p.W;
  const bool self_col = p.k_new != nullptr;
  const long long head = ((long long)b * H + h) * kHeadDim;

  // q, k_new and v_new first: none of them waits for the position
  float vn = 0.f;
  if (tid < kHeadDim) {
    qd[tid] = (double)to_f(static_cast<const T*>(p.q)[head + tid]);
    if (self_col) {
      kn_s[tid] = to_f(static_cast<const T*>(p.k_new)[head + tid]);
      vn = to_f(static_cast<const T*>(p.v_new)[head + tid]);
    }
  }
  const int pos = p.pos[b];
  const int n = min(pos + 1, W), cur = pos % W;
  const int per = (n + C - 1) / C, s0 = min(n, rank * per), s1 = min(n, s0 + per);
  const long long slot_stride = (long long)H * kHeadDim;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * W * slot_stride + h * kHeadDim;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * W * slot_stride + h * kHeadDim;
  const int grp = tid / kLanes, c0 = (tid % kLanes) * kCols;
  __syncthreads();
  if (self_col && warp == 0) {  // the self score from q and the new k
    const double d = qd[lane] * (double)kn_s[lane] + qd[lane + 32] * (double)kn_s[lane + 32];
    const double s = warp_sum(d);
    if (lane == 0) self_sh = __fmul_rn((float)s, p.scale);
  }

  // scores over this CTA's slots [s0, s1), kLanes lanes a slot, kUnroll
  // slots' K rows in flight a lane; the current slot masked in self mode
  double qr[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) qr[j] = qd[c0 + j];
  float mloc = -INFINITY;
  for (int base = s0; base < s1; base += kGroups * kUnroll) {   // the same trips in every warp
    Vec<T, kCols> rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + grp + u * kGroups;
      if (s < s1) rows[u] = load_vec<T, kCols>(kb + (long long)s * slot_stride + c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + grp + u * kGroups;
      double acc = 0.0;
      if (s < s1) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc += qr[j] * (double)rows[u][j];
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (s < s1) {
        const float v = (self_col && s == cur) ? -INFINITY : __fmul_rn((float)acc, p.scale);
        if (c0 == 0) sc[s - s0] = v;
        mloc = fmaxf(mloc, v);
      }
    }
  }
  const float m_cta = block_max_f(mloc, red);    // its barriers also publish sc and self_sh
  if (tid == 0) cta_max = m_cta;
  cluster.sync();                                // (1) the CTAs' maxima, lane r reads rank r
  const float self_s = self_col ? self_sh : -INFINITY;
  const float m = fmaxf(self_s, warp_max(lane < C ? *cluster.map_shared_rank(&cta_max, lane)
                                                  : -INFINITY));

  double sum = 0.0;
  for (int s = s0 + tid; s < s1; s += kThreads) {
    const float e = expf(__fsub_rn(sc[s - s0], m));
    sc[s - s0] = e;
    sum += (double)e;
  }
  const double sum_cta = block_sum_d(sum, dred);
  if (tid == 0) cta_sum = sum_cta;
  cluster.sync();                                // (2) the CTAs' f64 exp sums, in a fixed order
  const double total = warp_sum(lane < C ? *cluster.map_shared_rank(&cta_sum, lane) : 0.0);
  const float p_self = self_col ? expf(__fsub_rn(self_s, m)) : 0.f;
  const float denom = (float)(total + (double)p_self);
  for (int s = s0 + tid; s < s1; s += kThreads)
    sc[s - s0] = to_f(from_f<T>(__fdiv_rn(sc[s - s0], denom)));
  __syncthreads();

  // PV over this CTA's slots: kLanes lanes a slot, kCols columns a lane,
  // kUnroll slots' V rows in flight; rows of probability 0 are not read
  double acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0;
  for (int base = s0; base < s1; base += kGroups * kUnroll) {
    Vec<T, kCols> rows[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + grp + u * kGroups;
      w[u] = s < s1 ? sc[s - s0] : 0.f;
      if (w[u] != 0.f) rows[u] = load_vec<T, kCols>(vb + (long long)s * slot_stride + c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w[u] == 0.f) continue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] += (double)w[u] * (double)rows[u][j];
    }
  }
  // the 4 slot groups of a warp (lanes with the same tid % kLanes), then the warps
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < kLanes) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) pv[warp][c0 + j] = acc[j];
  }
  __syncthreads();
  if (tid < kHeadDim) {
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) part += pv[i][tid];
    cluster.map_shared_rank(&pv_all[0][0], 0)[rank * kHeadDim + tid] = part;
  }
  cluster.sync();                                // (3) the PV partials, in rank 0
  if (rank == 0 && tid < kHeadDim) {
    double tot = 0.0;
    for (int r = 0; r < C; ++r) tot += pv_all[r][tid];
    float o = (float)tot;
    if (self_col) o = __fadd_rn(o, __fmul_rn(__fdiv_rn(p_self, denom), vn));
    static_cast<T*>(p.out)[head + tid] = from_f<T>(o);
  }
}

}  // namespace

// q, k_new, v_new, out (B, H, D); k, v (B, W, H, D), all contiguous, bf16
// (bf16 = 1) or f32; pos (B,) int32 >= 0 on the device; k_new / v_new may be
// null (no self column). D must be 64; cluster, the CTAs a (head, row), 1-8.
extern "C" int mars5_decode_attention(int bf16, const void* q, const void* k, const void* v,
                                      const void* k_new, const void* v_new, const void* pos,
                                      void* out, int B, int W, int H, int D, int cluster,
                                      float scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || D != kHeadDim || W <= 0 ||
      W > kMaxWindow || cluster < 1 || cluster > kMaxCluster ||
      (k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_new, v_new, static_cast<const int*>(pos), out, W, H, scale};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)((W + cluster - 1) / cluster) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = bf16 ? cudaLaunchKernelEx(&cfg, decode_attention_kernel<__nv_bfloat16>, a)
                               : cudaLaunchKernelEx(&cfg, decode_attention_kernel<float>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
