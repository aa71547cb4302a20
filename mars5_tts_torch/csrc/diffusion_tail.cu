// The diffusion tail for Hopper (sm_90a): K6 heads_diffusion_tail (folded
// heads GEMM + tail) and K5 diffusion_tail (the tail from bf16 head logits).
//
// K6 replaces the TPU kernel
// mars5_tts_tpu/ops/pallas/diffusion_tail.py::_heads_tail_kernel (entry
// heads_diffusion_tail), K5 its ::_tail_kernel (entry diffusion_tail), the
// second program of the JAX two-program chain. Per generated frame f and
// lane h:
//
//   z_r[c]  = bf16(acc_r[c] * (xs_r * s[h][c]) + b[h][c])     r = cond, uncond
//   z[c]    = w * z_cond[c] + (1 - w) * z_uncond[c]            (f32; cond only if w = 1)
//   s[c]    = z[c] / temp
//   log_x0  = (s - max s) - log(sum exp(s - max s))    (the sum in f64, rounded once)
//   lev     = log_x0 + a  log-add-exp  b1      (log_x0 at t = 0)
//   y[c]    = lev + (c == x_t ? hot : cold) + use_g * gumbel(u0[c])
//   out     = argmax_c y[c]                    (ties to the lowest class)
//
//   x8 (rows, L, D) int8, xs (rows, L) f32 (cond rows, then uncond rows when
//   rows = 2 bs); q (n, K, D) int8, s/b (n, K) f32; u0 (bs, L, n, K) f32;
//   x_t (bs, L, n) int64; scalars (8,) f32 [a, b1, hot, cold, is_t0, use_g];
//   out (bs, L, n) int64. K5 takes z_r from logits (rows, L, n, K) bf16 (the
//   folded heads' output, models/nar.nar_heads_folded) in place of the GEMM.
//
// What bounds it here: at the bench shape (2 CFG rows x 750 frames x 7 lanes
// x 1025 classes, D = 1024) one call streams 21.5 MB of uniforms and does
// 11 G int8 MACs against 7 MB of folded head weights. The TPU kernel held
// 128 frames x 1152 classes f32 in VMEM; here a block takes 16 frames of one
// lane: their cond and uncond int8 activations go to shared memory, 4 warps
// walk the classes in 8-wide tiles with mma.sync.m16n8k32 (s8 x s8 -> s32,
// weight fragments read straight from L2), and the combined, tempered f32
// logits of the 16 frames (66 KB) stay in shared memory. The log-sum-exp
// must be final before the Gumbel argmax, because the hot/cold select and
// the noise are not monotone in the logit, so a second pass gives one warp
// to each frame for max, sum, and the fused posterior + argmax, reading the
// uniforms once, unpadded and coalesced. Products and sums use __fmul_rn /
// __fadd_rn so no FMA contraction changes a rounding against the plain
// version. No wgmma, TMA or in-kernel random numbers yet.
//
// K5 is memory-bound: at the bench shape it reads 21.5 MB of bf16 logits and
// 21.5 MB of uniforms (13 us at 3.35 TB/s). A block stages 16 frames of one
// lane, combined and tempered, in shared memory and runs the same __device__
// tail (tail_rows) as K6, so K5 picks K6's indices from the same logits.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kFR = 16;          // frames per block (one m16 tile)
constexpr int kThreads = 128;
constexpr int kMaxK = 2048;
constexpr int kMaxD = 2048;
constexpr int kMaxSmem = 2 * kFR * (kMaxD + 16) + kFR * (kMaxK + 12) * 4 + 2 * kFR * 4;

// What the tail reads and writes besides the tempered logits.
struct Tail {
  const float* u0;
  const long long* xt;
  const float* scal;
  long long* out;
  int L, n_lanes, K;
};

// The tail of frames f0.. of lane h, batch row b, from their tempered,
// combined logits S (kFR rows of stride s_stride in shared memory): one warp
// per frame takes the max, the f64 sum of exp, the posterior and the
// Gumbel argmax (ties to the lowest class). Shared by K6 and K5.
__device__ void tail_rows(const float* S, int s_stride, int f0, int h, int b, const Tail& p,
                          int warp, int lane) {
  const float a = p.scal[0], b1 = p.scal[1], hot = p.scal[2], cold = p.scal[3];
  const bool is_t0 = p.scal[4] > 0.5f;
  const float use_g = p.scal[5];
  for (int r = warp; r < kFR; r += kThreads / 32) {
    const int f = f0 + r;
    if (f >= p.L) break;
    const float* srow = S + r * s_stride;
    float m = -INFINITY;
    for (int c = lane; c < p.K; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    double sum = 0.0;
    for (int c = lane; c < p.K; c += 32) sum += (double)expf(__fsub_rn(srow[c], m));
    const float lse = logf((float)warp_sum(sum));
    const long long pos = ((long long)b * p.L + f) * p.n_lanes + h;
    const long long xt = p.xt[pos];
    const float* urow = p.u0 + pos * p.K;
    float best = -INFINITY;
    int best_c = 0x7fffffff;
    for (int c = lane; c < p.K; c += 32) {
      const float log_x0 = __fsub_rn(__fsub_rn(srow[c], m), lse);
      float lev = log_x0;
      if (!is_t0) {
        const float la = __fadd_rn(log_x0, a);
        const float mx = fmaxf(la, b1);
        lev = __fadd_rn(mx, logf(__fadd_rn(expf(__fsub_rn(la, mx)), expf(__fsub_rn(b1, mx)))));
      }
      const float un = __fadd_rn(lev, c == xt ? hot : cold);
      const float gm = -logf(fmaxf(-logf(fmaxf(urow[c], 1e-7f)), 1e-7f));
      const float y = __fadd_rn(un, __fmul_rn(gm, use_g));
      if (y > best) {  // classes rise along a lane: the first maximum stays
        best = y;
        best_c = c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, o);
      if (ob > best || (ob == best && oc < best_c)) {
        best = ob;
        best_c = oc;
      }
    }
    if (lane == 0) p.out[pos] = best_c;
  }
}

struct Args {
  const int8_t* x8;
  const float* xs;
  const int8_t* q;
  const float* s;
  const float* b;
  const float* u0;
  const long long* xt;
  const float* scal;
  long long* out;
  int bs, rows, L, n_lanes, K, D;
  float w, temp;
};

__global__ void __launch_bounds__(kThreads)
heads_tail_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, a_stride = D + 16;
  const int kp = ((p.K + 7) / 8) * 8, s_stride = kp + 4;
  int8_t* Ac = reinterpret_cast<int8_t*>(smem);
  int8_t* Au = Ac + kFR * a_stride;
  float* S = reinterpret_cast<float*>(Au + kFR * a_stride);
  float* xsc = S + kFR * s_stride;
  float* xsu = xsc + kFR;

  const int f0 = blockIdx.x * kFR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool cfg2 = p.rows == 2 * p.bs;

  // stage the 16 frames' int8 activations (cond and uncond rows); past L: 0
  const int chunks = D / 16;
  for (int c = tid; c < 2 * kFR * chunks; c += kThreads) {
    const int which = c / (kFR * chunks), r = (c / chunks) % kFR, col = (c % chunks) * 16;
    const int f = f0 + r, row = which == 0 ? b : p.bs + b;
    int4 v = make_int4(0, 0, 0, 0);
    if (f < p.L && (which == 0 || cfg2))
      v = *reinterpret_cast<const int4*>(p.x8 + ((long long)row * p.L + f) * D + col);
    *reinterpret_cast<int4*>((which == 0 ? Ac : Au) + r * a_stride + col) = v;
  }
  if (tid < 2 * kFR) {
    const int which = tid / kFR, r = tid % kFR, f = f0 + r;
    const int row = which == 0 ? b : p.bs + b;
    float v = 0.f;
    if (f < p.L && (which == 0 || cfg2)) v = p.xs[(long long)row * p.L + f];
    (which == 0 ? xsc : xsu)[r] = v;
  }
  __syncthreads();

  // phase 1: head GEMM of both rows, bf16 logits, CFG combine, temperature
  const int8_t* qh = p.q + (long long)h * p.K * D;
  const float* sh = p.s + (long long)h * p.K;
  const float* bh = p.b + (long long)h * p.K;
  const float w1 = __fsub_rn(1.f, p.w);
  const int8_t* ac_lo = Ac + g * a_stride + 4 * t;
  const int8_t* au_lo = Au + g * a_stride + 4 * t;
  for (int nt = warp; nt < kp / 8; nt += 4) {
    const int cls = nt * 8 + g;                  // this lane's B column
    const int8_t* qrow = qh + (long long)min(cls, p.K - 1) * D + 4 * t;
    const bool live = cls < p.K;
    int accc[4] = {0, 0, 0, 0}, accu[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 32) {
      uint32_t bf[2] = {0u, 0u};
      if (live) {
        bf[0] = __ldg(reinterpret_cast<const unsigned int*>(qrow + kk));
        bf[1] = __ldg(reinterpret_cast<const unsigned int*>(qrow + kk + 16));
      }
      const uint32_t ac[4] = {*reinterpret_cast<const uint32_t*>(ac_lo + kk),
                              *reinterpret_cast<const uint32_t*>(ac_lo + 8 * a_stride + kk),
                              *reinterpret_cast<const uint32_t*>(ac_lo + kk + 16),
                              *reinterpret_cast<const uint32_t*>(ac_lo + 8 * a_stride + kk + 16)};
      mma_s8_16832(accc, ac, bf);
      if (cfg2) {
        const uint32_t au[4] = {*reinterpret_cast<const uint32_t*>(au_lo + kk),
                                *reinterpret_cast<const uint32_t*>(au_lo + 8 * a_stride + kk),
                                *reinterpret_cast<const uint32_t*>(au_lo + kk + 16),
                                *reinterpret_cast<const uint32_t*>(au_lo + 8 * a_stride + kk + 16)};
        mma_s8_16832(accu, au, bf);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i >> 1), c = nt * 8 + 2 * t + (i & 1);
      if (c >= p.K) continue;
      const float sc = sh[c], bc = bh[c];
      float z = __bfloat162float(__float2bfloat16_rn(
          __fadd_rn(__fmul_rn((float)accc[i], __fmul_rn(xsc[r], sc)), bc)));
      if (cfg2) {
        const float zu = __bfloat162float(__float2bfloat16_rn(
            __fadd_rn(__fmul_rn((float)accu[i], __fmul_rn(xsu[r], sc)), bc)));
        z = __fadd_rn(__fmul_rn(p.w, z), __fmul_rn(w1, zu));
      }
      S[r * s_stride + c] = __fdiv_rn(z, p.temp);
    }
  }
  __syncthreads();

  // phase 2: one warp per frame: log-softmax, posterior, Gumbel argmax
  tail_rows(S, s_stride, f0, h, b, Tail{p.u0, p.xt, p.scal, p.out, p.L, p.n_lanes, p.K}, warp,
            lane);
}

// K5: the combined, tempered logits of 16 frames of one lane, staged from the
// bf16 head logits, then K6's tail.
__global__ void __launch_bounds__(kThreads)
tail_kernel(const __nv_bfloat16* __restrict__ logits, int bs, int rows, float w, float temp,
            Tail p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const int s_stride = ((p.K + 7) / 8) * 8 + 4;
  const int f0 = blockIdx.x * kFR, h = blockIdx.y, b = blockIdx.z;
  const bool cfg2 = rows == 2 * bs;
  const float w1 = __fsub_rn(1.f, w);
  for (int i = threadIdx.x; i < kFR * p.K; i += kThreads) {
    const int r = i / p.K, c = i - r * p.K, f = f0 + r;
    if (f >= p.L) break;
    const long long at = (((long long)b * p.L + f) * p.n_lanes + h) * p.K + c;
    float z = __bfloat162float(logits[at]);
    if (cfg2) {
      const float zu = __bfloat162float(logits[at + (long long)bs * p.L * p.n_lanes * p.K]);
      z = __fadd_rn(__fmul_rn(w, z), __fmul_rn(w1, zu));
    }
    S[r * s_stride + c] = __fdiv_rn(z, temp);
  }
  __syncthreads();
  tail_rows(S, s_stride, f0, h, b, p, threadIdx.x >> 5, threadIdx.x & 31);
}

}  // namespace

extern "C" int mars5_heads_diffusion_tail(const void* x8, const void* xs, const void* q,
                                          const void* s, const void* b, const void* u0,
                                          const void* xt, const void* scal, void* out,
                                          int bs, int rows, int L, int n_lanes, int K, int D,
                                          float w, float temp, void* stream) {
  if (bs <= 0 || L <= 0 || n_lanes <= 0 || n_lanes > 65535 || bs > 65535 || K <= 0 ||
      K > kMaxK || D <= 0 || D % 32 || D > kMaxD || (rows != bs && rows != 2 * bs))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        heads_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  Args p{static_cast<const int8_t*>(x8), static_cast<const float*>(xs),
         static_cast<const int8_t*>(q), static_cast<const float*>(s),
         static_cast<const float*>(b), static_cast<const float*>(u0),
         static_cast<const long long*>(xt), static_cast<const float*>(scal),
         static_cast<long long*>(out), bs, rows, L, n_lanes, K, D, w, temp};
  const int kp = ((K + 7) / 8) * 8;
  const size_t smem = 2 * kFR * (size_t)(D + 16) + (size_t)kFR * (kp + 4) * 4 + 2 * kFR * 4;
  const dim3 grid((L + kFR - 1) / kFR, n_lanes, bs);
  heads_tail_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mars5_diffusion_tail(const void* logits, const void* u0, const void* xt,
                                    const void* scal, void* out, int bs, int rows, int L,
                                    int n_lanes, int K, float w, float temp, void* stream) {
  if (bs <= 0 || L <= 0 || n_lanes <= 0 || n_lanes > 65535 || bs > 65535 || K <= 0 ||
      K > kMaxK || (rows != bs && rows != 2 * bs))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFR * (kMaxK + 12) * 4);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const Tail p{static_cast<const float*>(u0), static_cast<const long long*>(xt),
               static_cast<const float*>(scal), static_cast<long long*>(out), L, n_lanes, K};
  const size_t smem = (size_t)kFR * (((K + 7) / 8) * 8 + 4) * 4;
  const dim3 grid((L + kFR - 1) / kFR, n_lanes, bs);
  tail_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), bs, rows, w, temp, p);
  return (int)cudaGetLastError();
}
