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
// layer at 24 heads of 64 in bf16), against ~128 flops a slot and head. The
// TPU kernel took 8 heads a program over the whole window. Here one block of
// 256 threads takes one (head, row) pair and reads only the valid slots, the
// first min(pos + 1, W) (all W once the ring has wrapped): one thread a slot
// for the scores (a 128-byte K row in 16-byte loads, the scores kept in
// shared memory), then 8 lanes a slot for PV (16 bytes each), skipping the
// V rows whose probability is 0. At batch 1 a call is launch-bound (24
// blocks); a split over the slots and one launch for all layers are later
// work.
//
// Numerics: the q . k dots, the softmax denominator and the PV sums
// accumulate in f64 (every product of two f32 or bf16 values is exact there)
// and round to f32 once, as the plain twin decode_attention_ref does; the
// rest is the same f32 ops: s = (float)dot * scale, p = expf(s - m),
// prob = p / denom (true division), out = (float)PV + (p_self / denom) * v.
//
// The C entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kPvLanes = 8;                       // lanes sharing one slot's V row
constexpr int kPvCols = kHeadDim / kPvLanes;      // columns a lane takes
constexpr int kPvGroups = kThreads / kPvLanes;    // slots in flight
constexpr int kMaxWindow = 8192;

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

// grid (H, B); dynamic shared memory: W floats (scores, then probabilities)
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  __shared__ double qd[kHeadDim];
  __shared__ float red[kWarps];
  __shared__ double dred[kWarps];
  __shared__ double pv[kWarps][kHeadDim];
  __shared__ float self_sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, H = p.H, W = p.W;
  const bool self_col = p.k_new != nullptr;
  const int pos = p.pos[b];
  const int n = min(pos + 1, W), cur = pos % W;
  const long long head = ((long long)b * H + h) * kHeadDim;
  const long long slot_stride = (long long)H * kHeadDim;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * W * slot_stride + h * kHeadDim;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * W * slot_stride + h * kHeadDim;

  if (tid < kHeadDim) qd[tid] = (double)to_f(static_cast<const T*>(p.q)[head + tid]);
  __syncthreads();
  if (self_col && warp == 0) {  // the self score from q and the new k
    const T* kn = static_cast<const T*>(p.k_new) + head;
    const double d = qd[lane] * (double)to_f(kn[lane]) + qd[lane + 32] * (double)to_f(kn[lane + 32]);
    const double s = warp_sum(d);
    if (lane == 0) self_sh = __fmul_rn((float)s, p.scale);
  }

  // scores over the valid slots [0, n), the current slot masked in self mode
  float mloc = -INFINITY;
  for (int s = tid; s < n; s += kThreads) {
    float v = -INFINITY;
    if (!(self_col && s == cur)) {
      const Vec<T, kHeadDim> row = load_vec<T, kHeadDim>(kb + (long long)s * slot_stride);
      double acc = 0.0;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) acc += qd[c] * (double)row[c];
      v = __fmul_rn((float)acc, p.scale);
    }
    sc[s] = v;
    mloc = fmaxf(mloc, v);
  }
  float m = block_max_f(mloc, red);    // its barriers also publish self_sh
  const float self_s = self_col ? self_sh : -INFINITY;
  m = fmaxf(m, self_s);

  double sum = 0.0;
  for (int s = tid; s < n; s += kThreads) {
    const float e = expf(__fsub_rn(sc[s], m));
    sc[s] = e;
    sum += (double)e;
  }
  const float p_self = self_col ? expf(__fsub_rn(self_s, m)) : 0.f;
  const float denom = (float)(block_sum_d(sum, dred) + (double)p_self);
  for (int s = tid; s < n; s += kThreads) sc[s] = to_f(from_f<T>(__fdiv_rn(sc[s], denom)));
  __syncthreads();

  // PV: kPvLanes lanes a slot, kPvCols columns a lane
  const int grp = tid / kPvLanes, c0 = (tid % kPvLanes) * kPvCols;
  double acc[kPvCols];
#pragma unroll
  for (int j = 0; j < kPvCols; ++j) acc[j] = 0.0;
  for (int s = grp; s < n; s += kPvGroups) {
    const float w = sc[s];
    if (w == 0.f) continue;
    const Vec<T, kPvCols> row = load_vec<T, kPvCols>(vb + (long long)s * slot_stride + c0);
#pragma unroll
    for (int j = 0; j < kPvCols; ++j) acc[j] += (double)w * (double)row[j];
  }
  // the 4 slot groups of a warp (lanes with the same tid % kPvLanes), then the warps
#pragma unroll
  for (int j = 0; j < kPvCols; ++j) {
#pragma unroll
    for (int o = kPvLanes; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < kPvLanes) {
#pragma unroll
    for (int j = 0; j < kPvCols; ++j) pv[warp][c0 + j] = acc[j];
  }
  __syncthreads();
  if (tid < kHeadDim) {
    double tot = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) tot += pv[i][tid];
    float o = (float)tot;
    if (self_col) {
      const float vn = to_f(static_cast<const T*>(p.v_new)[head + tid]);
      o = __fadd_rn(o, __fmul_rn(__fdiv_rn(p_self, denom), vn));
    }
    static_cast<T*>(p.out)[head + tid] = from_f<T>(o);
  }
}

}  // namespace

// q, k_new, v_new, out (B, H, D); k, v (B, W, H, D), all contiguous, bf16
// (bf16 = 1) or f32; pos (B,) int32 >= 0 on the device; k_new / v_new may be
// null (no self column). D must be 64.
extern "C" int mars5_decode_attention(int bf16, const void* q, const void* k, const void* v,
                                      const void* k_new, const void* v_new, const void* pos,
                                      void* out, int B, int W, int H, int D, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || D != kHeadDim || W <= 0 || W > kMaxWindow ||
      (k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_new, v_new, static_cast<const int*>(pos), out, W, H, scale};
  const dim3 grid(H, B);
  const size_t smem = (size_t)W * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(a);
  else
    decode_attention_kernel<float><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
