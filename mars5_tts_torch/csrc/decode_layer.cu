// Quantized AR decode step for Hopper (sm_90a): kernel K2 fused_decode_layers.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/decode_layer.py::
// _make_kernel (entry fused_decode_layers) at batch 1: one generated token
// through every layer of the AR backbone, W8A8 (wbits 8) or W4A8 (wbits 4,
// nibble-packed), ring attention over an int8 KV cache.
//
// The TPU kernel was one program that double-buffered weight chunks through
// VMEM. Here one C entry, mars5_fused_decode, issues a fixed sequence of
// small kernels on the caller's stream: a copy of the embedded row into h,
// then per layer
//   1. gemv<RMS>   h -> RMSNorm -> int8 -> wqkv                 -> q|k|v (f32)
//   2. attention   one block per head: RoPE on q and the new k, per-head q
//                  quant, int8 scores over the valid ring slots, the self
//                  column, p * vs quant, the int8 PV product
//   3. gemv<VEC>   attn -> int8 -> wo, h += result
//   4. gemv<RMS>   h -> RMSNorm -> int8 -> w13                   -> w1x|w3x
//   5. gemv<SILU>  silu(w1x) * w3x -> int8 -> w2 (both halves summed in int32),
//                  h += result
// Each GEMV launches two blocks an SM; every block computes the prologue (the
// whole-row RMS and amax) from device memory itself instead of taking it
// from an extra launch (the row is 6-14 KB and sits in L2), with its first
// weight rows already loading, then walks its rows.
//
// What bounds it: the weight stream (675 MB a token at W8, 337 MB at W4 at
// the released widths) plus the int8 K/V of the valid slots; the GEMVs are
// far below the tensor cores' break-even, so they use __dp4a on CUDA cores,
// one warp per output row with 16-byte streaming loads. Attention reads only
// the valid slots (the slot-validity mask would zero the rest) and skips the
// V rows whose quantized probability is 0. 1 + 5 x n_layers launches a token;
// a persistent kernel, CUDA graphs, wgmma and TMA are later work.
//
// Numerics, those of fused_step_emulation: xs = max(amax, 1e-8) / 127, q =
// rint(x / xs) clipped to +-127 (true division, round half to even); RMSNorm
// x * (1 / sqrt(mean(x * x) + eps)) * w; W8 rescale (acc * xs) * ws, W4
// (ya * sA + yb * sB) * xs, w2 (acc * us) * w2s; scores ((acc * qms) * ks) *
// scale, -inf outside the valid slots; the self score from the unquantized
// f32 q and k; p = exp(s - m), denom = sum + p_self; PV * ps / denom +
// (p_self / denom) * v; silu(a) = a * (1 / (1 + exp(-a))). The three sums
// (RMS, self score, denominator) accumulate in f64 and round to f32 once, as
// the plain twin does, so their order does not matter. Products and sums use
// __fmul_rn / __fadd_rn so no FMA contraction changes a rounding.
//
// The C entry returns the first cudaGetLastError() after a launch, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemv_s8.cuh"

namespace {

using namespace mars5;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = kWarps;  // rows a block takes per pass, one a warp
constexpr int kHeadDim = 64;
constexpr int kAttnThreads = 512;
constexpr int kAttnWarps = kAttnThreads / 32;

enum Prologue { kRms = 0, kVec = 1, kSilu = 2 };

struct GemvArgs {
  const int8_t* w;     // (N, K) int8, or (N, K/2) packed int4
  const float* s;      // W8 and single-scale W4: (N,); split W4: (2, N)
  const float* src;    // kRms: h (K); kVec: attn (K); kSilu: w1x | w3x (2K)
  const float* norm;   // kRms: RMSNorm weight (K)
  float* out;          // (N): stored, or added to when resid
  int N, K;
  float eps;
  int resid;
};

// The activation row every block quantizes into shared memory: x8 (K bytes)
// and its scale. `act` (K floats) keeps the f32 values between the passes.
template <int kPro>
__device__ void prologue(const GemvArgs& p, float* act, int8_t* x8, float* xs_out,
                         float* red, double* dred) {
  const int tid = threadIdx.x, K = p.K;
  float amax = 0.f;
  if (kPro == kRms) {  // r = 1 / sqrt(sum(x * x) / K + eps)
    double ss = 0.0;
    for (int c = tid; c < K; c += kThreads) {
      const float v = p.src[c];
      ss += (double)__fmul_rn(v, v);
    }
    const float mean = __fdiv_rn(block_sum<kWarps>(ss, dred), (float)K);
    const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, p.eps)));
    for (int c = tid; c < K; c += kThreads) {
      const float a = __fmul_rn(__fmul_rn(p.src[c], r), p.norm[c]);
      act[c] = a;
      amax = fmaxf(amax, fabsf(a));
    }
  } else if (kPro == kVec) {
    for (int c = tid; c < K; c += kThreads) {
      const float a = p.src[c];
      act[c] = a;
      amax = fmaxf(amax, fabsf(a));
    }
  } else {  // silu(a) * b, silu(a) = a * (1 / (1 + exp(-a)))
    for (int c = tid; c < K; c += kThreads) {
      const float a = p.src[c], b = p.src[K + c];
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
      const float u = __fmul_rn(__fmul_rn(a, sig), b);
      act[c] = u;
      amax = fmaxf(amax, fabsf(u));
    }
  }
  const float xs = row_scale(block_max<kWarps>(amax, red));
  for (int c = tid; c < K; c += kThreads) x8[c] = (int8_t)quant127(act[c], xs);
  if (tid == 0) *xs_out = xs;
  __syncthreads();
}

// kW4: packed int4 rows; kSplit: one scale per half (else one per row, the
// halves summed in int32 first). The grid is a fixed number of blocks per SM
// (see gemv below): each block quantizes the activation once and its warps
// walk their rows with a stride, the next row's loads in flight while the
// current one is multiplied.
template <int kPro, bool kW4, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) gemv_kernel(GemvArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  __shared__ double dred[kWarps];
  __shared__ float xs_sh;
  float* act = reinterpret_cast<float*>(smem);
  int8_t* x8 = reinterpret_cast<int8_t*>(act + p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int row_bytes = kW4 ? p.K / 2 : p.K;
  const int n_chunks = row_bytes / 16;

  int row = blockIdx.x * kWarps + warp;
  RowRegs cur;
  if (row < p.N) load_row(cur, p.w + (long long)row * row_bytes, n_chunks, lane);
  prologue<kPro>(p, act, x8, &xs_sh, red, dred);
  const float xs = xs_sh;

  for (; row < p.N; row += stride) {
    RowRegs next;
    if (row + stride < p.N)
      load_row(next, p.w + (long long)(row + stride) * row_bytes, n_chunks, lane);
    float v;
    if (kW4) {
      int ya = 0, yb = 0;
      dot_s4(cur, x8, row_bytes, n_chunks, lane, ya, yb);
      if (kSplit) {
        ya = warp_isum(ya);
        yb = warp_isum(yb);
        v = __fmul_rn(__fadd_rn(__fmul_rn((float)ya, p.s[row]),
                                __fmul_rn((float)yb, p.s[p.N + row])), xs);
      } else {
        v = __fmul_rn(__fmul_rn((float)warp_isum(ya + yb), xs), p.s[row]);
      }
    } else {
      v = __fmul_rn(__fmul_rn((float)warp_isum(dot_s8(cur, x8, n_chunks, lane)), xs),
                    p.s[row]);
    }
    if (lane == 0) p.out[row] = p.resid ? __fadd_rn(p.out[row], v) : v;
    cur = next;
  }
}

struct AttnArgs {
  const float* qkv;               // (3d) q | k | v before RoPE
  const float* cos;               // (32)
  const float* sin;               // (32)
  const int8_t* ck;               // (w_pad, d) this layer
  const int8_t* cv;
  const float* ks;                // (w_pad) per-position scales
  const float* vs;
  float* k_new;                   // (d) this layer
  float* v_new;
  float* attn;                    // (d)
  int d, window, pos;
};

// rope of column c (0..63) of one head: x * cos + (+-pair) * sin
__device__ __forceinline__ float rope64(const float* x, int c, const float* cos, const float* sin) {
  const int i = c & 31;
  const float pr = c < 32 ? -x[c + 32] : x[c - 32];
  return __fadd_rn(__fmul_rn(x[c], cos[i]), __fmul_rn(pr, sin[i]));
}

// One block per head (kAttnThreads threads); dynamic shared memory: scores
// (n floats) then pv8 (n bytes). The slot loops load two slots a thread
// before using either, and the PV product gives each group of 4 lanes one
// slot's 64-byte V row (16 columns a lane), so many loads are in flight.
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qf[kHeadDim], kf[kHeadDim], vf[kHeadDim];
  __shared__ __align__(16) int8_t q8[kHeadDim];
  __shared__ float red[kAttnWarps];
  __shared__ double dred[kAttnWarps];
  __shared__ float bc[2];
  __shared__ int pv_acc[kAttnWarps][kHeadDim];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kHeadDim, d = p.d;
  const int n = min(p.pos + 1, p.window), cur = p.pos % p.window;
  const float scale = 1.f / sqrtf((float)kHeadDim);
  float* sc = reinterpret_cast<float*>(smem);
  int8_t* pv8 = reinterpret_cast<int8_t*>(sc + n);

  if (tid < kHeadDim) {
    const float* q = p.qkv + base;
    const float* k = p.qkv + d + base;
    const float v = p.qkv[2 * d + base + tid];
    qf[tid] = rope64(q, tid, p.cos, p.sin);
    kf[tid] = rope64(k, tid, p.cos, p.sin);
    vf[tid] = v;
    p.k_new[base + tid] = kf[tid];
    p.v_new[base + tid] = v;
  }
  __syncthreads();
  if (tid < 32) {  // per-head q quant and the self score
    const float qms = row_scale(warp_max(fmaxf(fabsf(qf[tid]), fabsf(qf[tid + 32]))));
    q8[tid] = (int8_t)quant127(qf[tid], qms);
    q8[tid + 32] = (int8_t)quant127(qf[tid + 32], qms);
    if (tid == 0) {
      double s = 0.0;
      for (int c = 0; c < kHeadDim; ++c) s += (double)__fmul_rn(qf[c], kf[c]);
      bc[0] = qms;
      bc[1] = __fmul_rn((float)s, scale);
    }
  }
  __syncthreads();
  const float qms = bc[0], self_s = bc[1];
  int qw[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) qw[j] = reinterpret_cast<const int*>(q8)[j];

  // scores over the valid slots [0, n) minus the current token's own slot
  float mloc = -INFINITY;
  for (int s0 = tid; s0 < n; s0 += 2 * kAttnThreads) {
    uint4 kv[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u * kAttnThreads;
      if (s < n) {
        const uint4* kr = reinterpret_cast<const uint4*>(p.ck + (long long)s * d + base);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[u][j] = kr[j];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u * kAttnThreads;
      if (s < n) {
        float v = -INFINITY;
        if (s != cur) {
          int acc = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc = dp4a4(kv[u][j], make_uint4(qw[4 * j], qw[4 * j + 1],
                                                                      qw[4 * j + 2], qw[4 * j + 3]),
                                                  acc);
          v = __fmul_rn(__fmul_rn(__fmul_rn((float)acc, qms), p.ks[s]), scale);
        }
        sc[s] = v;
        mloc = fmaxf(mloc, v);
      }
    }
  }
  const float m = fmaxf(block_max<kAttnWarps>(mloc, red), self_s);

  double sum = 0.0;
  float amax = 0.f;
  for (int s = tid; s < n; s += kAttnThreads) {
    float pvs = 0.f;
    if (s != cur) {
      const float e = expf(__fsub_rn(sc[s], m));
      sum += (double)e;
      pvs = __fmul_rn(e, p.vs[s]);
    }
    sc[s] = pvs;
    amax = fmaxf(amax, fabsf(pvs));
  }
  const float denom_part = block_sum<kAttnWarps>(sum, dred);
  const float ps = row_scale(block_max<kAttnWarps>(amax, red));
  const float p_self = expf(__fsub_rn(self_s, m));
  const float denom = __fadd_rn(denom_part, p_self);
  for (int s = tid; s < n; s += kAttnThreads) pv8[s] = (int8_t)quant127(sc[s], ps);
  __syncthreads();

  // int8 PV: lane group g = tid / 4 takes slots g, g + G, ...; lane tid % 4
  // takes 16 of the head's 64 columns (one 16-byte load a slot)
  const int cg = tid & 3, groups = kAttnThreads / 4;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int s0 = tid >> 2; s0 < n; s0 += 2 * groups) {
    uint4 vv[2];
    int w[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u * groups;
      w[u] = s < n ? pv8[s] : 0;
      if (w[u] != 0)
        vv[u] = *reinterpret_cast<const uint4*>(p.cv + (long long)s * d + base + 16 * cg);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (w[u] == 0) continue;
      const uint32_t words[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += w[u] * (int)(int8_t)(words[j >> 2] >> (8 * (j & 3)));
    }
  }
  // sum the 8 slot groups of each warp (lanes with the same tid % 4), then the warps
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) pv_acc[warp][16 * lane + j] = acc[j];
  }
  __syncthreads();
  if (tid < kHeadDim) {
    int tot = 0;
#pragma unroll
    for (int i = 0; i < kAttnWarps; ++i) tot += pv_acc[i][tid];
    const float out = __fmul_rn((float)tot, ps);
    p.attn[base + tid] = __fadd_rn(__fdiv_rn(out, denom),
                                   __fmul_rn(__fdiv_rn(p_self, denom), vf[tid]));
  }
}

__global__ void load_x_kernel(const __nv_bfloat16* x, float* h, int d) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < d; c += gridDim.x * blockDim.x)
    h[c] = __bfloat162float(x[c]);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Two blocks an SM (or fewer when the rows run out), so the prologue runs
// once per block and every SM streams its share of the rows.
template <int kPro, bool kW4, bool kSplit>
cudaError_t gemv(const GemvArgs& p, cudaStream_t st) {
  const size_t smem = (size_t)p.K * 5;  // act floats + x8 bytes
  const int blocks = min((p.N + kRowsPerBlock - 1) / kRowsPerBlock, 2 * sm_count());
  gemv_kernel<kPro, kW4, kSplit><<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int kPro>
cudaError_t gemv_w(int wbits, bool split, const GemvArgs& p, cudaStream_t st) {
  if (wbits == 8) return gemv<kPro, false, false>(p, st);
  return split ? gemv<kPro, true, true>(p, st) : gemv<kPro, true, false>(p, st);
}

}  // namespace

extern "C" int mars5_fused_decode(int wbits, int L, int d, int hidden, int n_heads, int window,
                                  int w_pad, int pos, float eps, const void* x, const void* cos,
                                  const void* sin, const void* wqkv, const void* sqkv,
                                  const void* wo, const void* so, const void* w13,
                                  const void* s13, const void* w2, const void* s2,
                                  const void* attn_norms, const void* ffn_norms,
                                  const void* cache_k, const void* cache_v, const void* kv_scales,
                                  void* h, void* k_new, void* v_new, void* scratch,
                                  void* stream) {
  const int div = wbits == 4 ? 2 : 1, g = wbits == 4 ? 2 : 1;
  if ((wbits != 8 && wbits != 4) || L <= 0 || d != n_heads * kHeadDim || window <= 0 ||
      w_pad < window || pos < 0 || (d / div) % 16 || (hidden / div) % 16 ||
      d / div > 16 * 32 * kMaxChunks || hidden / div > 16 * 32 * kMaxChunks ||
      (size_t)window * 5 > 40 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  float* qkv = static_cast<float*>(scratch);
  float* attn = qkv + 3 * d;
  float* ab = attn + d;

  load_x_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), hf, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t attn_smem = (size_t)window * 5;
  for (int l = 0; l < L; ++l) {
    const float* an = static_cast<const float*>(attn_norms) + (long long)l * d;
    const float* fn = static_cast<const float*>(ffn_norms) + (long long)l * d;
    GemvArgs pq{static_cast<const int8_t*>(wqkv) + (long long)l * 3 * d * (d / div),
                static_cast<const float*>(sqkv) + (long long)l * g * 3 * d, hf, an, qkv,
                3 * d, d, eps, 0};
    if ((e = gemv_w<kRms>(wbits, true, pq, st)) != cudaSuccess) return (int)e;

    AttnArgs pa{qkv, static_cast<const float*>(cos), static_cast<const float*>(sin),
                static_cast<const int8_t*>(cache_k) + (long long)l * w_pad * d,
                static_cast<const int8_t*>(cache_v) + (long long)l * w_pad * d,
                static_cast<const float*>(kv_scales) + (long long)l * 2 * w_pad,
                static_cast<const float*>(kv_scales) + (long long)l * 2 * w_pad + w_pad,
                static_cast<float*>(k_new) + (long long)l * d,
                static_cast<float*>(v_new) + (long long)l * d, attn, d, window, pos};
    attention_kernel<<<n_heads, kAttnThreads, attn_smem, st>>>(pa);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

    GemvArgs po{static_cast<const int8_t*>(wo) + (long long)l * d * (d / div),
                static_cast<const float*>(so) + (long long)l * g * d, attn, nullptr, hf,
                d, d, eps, 1};
    if ((e = gemv_w<kVec>(wbits, true, po, st)) != cudaSuccess) return (int)e;

    GemvArgs pf{static_cast<const int8_t*>(w13) + (long long)l * 2 * hidden * (d / div),
                static_cast<const float*>(s13) + (long long)l * g * 2 * hidden, hf, fn, ab,
                2 * hidden, d, eps, 0};
    if ((e = gemv_w<kRms>(wbits, true, pf, st)) != cudaSuccess) return (int)e;

    GemvArgs p2{static_cast<const int8_t*>(w2) + (long long)l * d * (hidden / div),
                static_cast<const float*>(s2) + (long long)l * d, ab, nullptr, hf,
                d, hidden, eps, 1};
    if ((e = gemv_w<kSilu>(wbits, false, p2, st)) != cudaSuccess) return (int)e;
  }
  return 0;
}
