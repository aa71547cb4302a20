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
// What bounds K6: at the bench shape (2 CFG rows x 750 frames x 7 lanes x
// 1025 classes, D = 1024) one call does 11 G int8 MACs (11.1 us at the int8
// peak) against 7 MB of folded head weights and streams 21.5 MB of uniforms.
// The TPU kernel held 128 frames x 1152 classes f32 in VMEM. The log-sum-exp
// must be final before the Gumbel argmax (the hot/cold select and the noise
// are not monotone in the logit, and an online rescale would change the f32
// exp terms the f64 sum adds). A block holding every class of its frames in
// shared memory (32 frames: 131 KB) leaves room for a few weight stages only
// and one block an SM, and its tail cannot overlap anything. So K6 is two
// launches from one C call (a plan of diffusion_tail.heads_tail_plan):
//   1. heads_gemm_kernel: a block takes 32 frames of one lane. A: their int8
//      rows, cond and uncond, loaded once by TMA (3-D map, zero fill past L)
//      as one 64-row wgmma operand: 8-row groups alternate cond frames
//      8i..8i+7 and uncond frames 8i..8i+7, so a thread's accumulator rows g
//      and g + 8 are the cond and uncond row of one frame. B: the lane's
//      weights in tiles of 64 classes x 128 bytes, TMA into a ring of
//      mbarrier stages (one producer warp), each tile feeding all 64 A rows
//      through wgmma.m64n64k32.s32.s8.s8 (one consumer warpgroup), so the 1 MB
//      of a lane's weights is read once a 32 frames. Two blocks fit an SM, so
//      the grid (24 x 7 at the bench shape) is one wave. The epilogue
//      combines cond and uncond in registers, in the twin's order
//      (__fmul_rn / __fadd_rn), and writes s = z / temp, f32, into a scratch
//      laid out as the uniforms (21.5 MB: it stays in the 50 MB L2).
//      1025 = 16 x 64 + 1: the last tile's 63 padded classes are zero-filled
//      weights; they are never written, and the tail reads classes < K only,
//      so they take no part in the max, the sum or the argmax.
//   2. tail_kernel<true>: 8 (frame, lane) rows a block, one warp a row (K5's
//      kernel on f32 input).
//
// The tail (tail_rows, shared by K6 and K5, so K5 picks K6's indices from
// the same logits): a warp a row issues its row of uniforms as 16-byte
// loads (a row is 4 K bytes, so the first few classes before a 16-byte
// boundary and the last few after one are loaded alone), takes the max and
// the f64 sum of exp from shared memory (four partials a lane) while they
// are in flight, then the posterior and the Gumbel argmax. Products and sums
// use __fmul_rn / __fadd_rn so no FMA contraction changes a rounding against
// the twins.
//
// K5 is memory-bound: at the bench shape it reads 21.5 MB of bf16 logits and
// 21.5 MB of uniforms (13 us at 3.35 TB/s). A block takes 8 consecutive
// (frame, lane) rows, whose logits are one contiguous span of each CFG half:
// it stages them with 16-byte loads, combined and tempered, in shared memory
// and runs tail_rows.
//
// The C entry points return the launch's cudaError.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kMaxK = 2048;
constexpr int kMaxVec = kMaxK / 4 / 32;     // 16-byte loads of uniforms a lane, at most

// What the tail reads and writes besides the tempered logits.
struct Tail {
  const float* u0;
  const long long* xt;
  const float* scal;
  long long* out;
  int L, n_lanes, K;
};

// The tail of n_rows (frame, lane) rows, row r at index pos0 + r * stride of
// the (bs, L, n) grid, from their tempered, combined logits S (rows of
// s_stride floats in shared memory), one warp a row: max, f64 sum of exp,
// posterior, Gumbel argmax (ties to the lowest class).
__device__ void tail_rows(const float* S, int s_stride, int n_rows, long long pos0, int stride,
                          const Tail& p, int warp, int lane, int n_warps) {
  const float a = p.scal[0], b1 = p.scal[1], hot = p.scal[2], cold = p.scal[3];
  const bool is_t0 = p.scal[4] > 0.5f;
  const float use_g = p.scal[5];
  const int K = p.K;
  auto score = [&](float s, float m, float lse, int c, long long xt, float u) {
    const float log_x0 = __fsub_rn(__fsub_rn(s, m), lse);
    float lev = log_x0;
    if (!is_t0) {
      const float la = __fadd_rn(log_x0, a);
      const float mx = fmaxf(la, b1);
      lev = __fadd_rn(mx, logf(__fadd_rn(expf(__fsub_rn(la, mx)), expf(__fsub_rn(b1, mx)))));
    }
    const float un = __fadd_rn(lev, c == xt ? hot : cold);
    const float gm = -logf(fmaxf(-logf(fmaxf(u, 1e-7f)), 1e-7f));
    return __fadd_rn(un, __fmul_rn(gm, use_g));
  };
  for (int r = warp; r < n_rows; r += n_warps) {
    const long long pos = pos0 + (long long)r * stride;
    const float* urow = p.u0 + pos * K;
    // the row's uniforms: `lead` classes to a 16-byte boundary, nv vectors, the rest
    const int lead = min((4 - (int)((pos * K) & 3)) & 3, K);
    const int nv = (K - lead) / 4, rest = K - lead - 4 * nv;
    float4 uv[kMaxVec];
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
      if (lane + 32 * i < nv) uv[i] = __ldg(reinterpret_cast<const float4*>(urow + lead) + lane + 32 * i);
    const float u_lead = lane < lead ? __ldg(urow + lane) : 0.f;
    const float u_rest = lane < rest ? __ldg(urow + lead + 4 * nv + lane) : 0.f;
    const long long xt = __ldg(p.xt + pos);

    const float* srow = S + r * s_stride;
    float mp[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int c0 = lane; c0 < K; c0 += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + 32 * j < K) mp[j] = fmaxf(mp[j], srow[c0 + 32 * j]);
    }
    const float m = warp_max(fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3])));
    double sp[4] = {0.0, 0.0, 0.0, 0.0};
    for (int c0 = lane; c0 < K; c0 += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + 32 * j < K) sp[j] += (double)expf(__fsub_rn(srow[c0 + 32 * j], m));
    }
    const float lse = logf((float)warp_sum((sp[0] + sp[1]) + (sp[2] + sp[3])));

    float best = -INFINITY;
    int best_c = 0x7fffffff;
    auto take = [&](int c, float u) {   // classes rise along a lane: the first maximum stays
      const float y = score(srow[c], m, lse, c, xt, u);
      if (y > best) {
        best = y;
        best_c = c;
      }
    };
    if (lane < lead) take(lane, u_lead);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int v = lane + 32 * i;
      if (v < nv) {
        const int c = lead + 4 * v;
        take(c, uv[i].x);
        take(c + 1, uv[i].y);
        take(c + 2, uv[i].z);
        take(c + 3, uv[i].w);
      }
    }
    if (lane < rest) take(lead + 4 * nv + lane, u_rest);
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

// ---- K6, launch 1: the heads GEMM -----------------------------------------

constexpr int kFrames = 32;                 // frames a block: 64 A rows, cond and uncond
constexpr int kClassTile = 64;              // classes a B tile (the wgmma width)
constexpr int kSlice = 128;                 // k bytes a stage (one 128-byte swizzle row)
constexpr int kTileBytes = 64 * kSlice;     // an A slice or a B stage: 64 rows x 128 bytes
constexpr int kGemmThreads = 160;           // warps 0-3 wgmma and the epilogue, warp 4 TMA

struct GemmArgs {
  const float* xs;
  const float* s;
  const float* b;
  float* z;                                 // (bs, L, n, K): s = z / temp
  int bs, rows, L, n_lanes, K, D, class_tiles, stages;
  float w, temp;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kGemmThreads, 2)
heads_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tq,
                  GemmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nk = p.D / kSlice, K = p.K, L = p.L;
  const uint32_t a_sm = smem_addr(smem);                       // nk slices of 8 KB
  const uint32_t b_sm = a_sm + nk * kTileBytes;                // the ring
  const uint32_t a_bar = b_sm + p.stages * kTileBytes;
  const uint32_t full = a_bar + 8, empty = full + 8 * p.stages;
  const int f0 = blockIdx.x * kFrames, h = blockIdx.y, b = blockIdx.z;
  const bool cfg2 = p.rows == 2 * p.bs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(a_bar, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);                             // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: A once, then the lane's weight tiles through the ring
    if (lane == 0) {
      mbar_arrive_expect_tx(a_bar, nk * (cfg2 ? 8 : 4) * 1024);
      for (int kc = 0; kc < nk; ++kc)
        for (int gr = 0; gr < 8; ++gr) {
          if ((gr & 1) && !cfg2) continue;
          tma_load_3d(a_sm + kc * kTileBytes + gr * 1024, &ta, a_bar, kc * kSlice,
                      f0 + 8 * (gr >> 1), (gr & 1) ? p.bs + b : b);
        }
      int s = 0, ph = 0;
      for (int t = 0; t < p.class_tiles * nk; ++t) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, kTileBytes);
        tma_load_3d(b_sm + s * kTileBytes, &tq, full + 8 * s, (t % nk) * kSlice,
                    (t / nk) * kClassTile, h);
        if (++s == p.stages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: rows 16 warp + g (cond) and + 8 (uncond) of frame 8 warp + g
  const int g = lane >> 2, q4 = lane & 3;
  const int f = f0 + 8 * warp + g;
  const bool live = f < L;
  float xsc = 0.f, xsu = 0.f;
  if (live) {
    xsc = __ldg(p.xs + (long long)b * L + f);
    if (cfg2) xsu = __ldg(p.xs + (long long)(p.bs + b) * L + f);
  }
  const float* sh = p.s + (long long)h * K;
  const float* bh = p.b + (long long)h * K;
  const float w1 = __fsub_rn(1.f, p.w);
  float* zrow = p.z + (((long long)b * L + f) * p.n_lanes + h) * K;
  int acc[32];
  mbar_wait(a_bar, 0);
  int s = 0, ph = 0, prev = 0;
  for (int ct = 0; ct < p.class_tiles; ++ct) {
    // the tile's scales and biases, columns 8 j + 2 q4 + e: loaded before
    // its products, used after them
    float sc[8][2], bc[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct * kClassTile + 8 * j + 2 * q4 + e;
        sc[j][e] = c < K ? __ldg(sh + c) : 0.f;
        bc[j][e] = c < K ? __ldg(bh + c) : 0.f;
      }
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = a_sm + kc * kTileBytes, bt = b_sm + s * kTileBytes;
      fence_regs<32>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 32; ++kk)
        wgmma_m64n64k32_s8(acc, wgmma_desc_sw128(a + 32 * kk, 0, 1024),
                           wgmma_desc_sw128(bt + 32 * kk, 0, 1024), kc > 0 || kk > 0);
      wgmma_commit();
      fence_regs<32>(acc);
      wgmma_wait<1>();                     // the slice before is done: hand its stage back
      if (kc > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == p.stages) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    fence_regs<32>(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ct * kClassTile + 8 * j + 2 * q4 + e;
        if (c >= K) continue;              // a padded class: never written, never read
        float z = bf16_round(
            __fadd_rn(__fmul_rn((float)acc[4 * j + e], __fmul_rn(xsc, sc[j][e])), bc[j][e]));
        if (cfg2) {
          const float zu = bf16_round(__fadd_rn(
              __fmul_rn((float)acc[4 * j + 2 + e], __fmul_rn(xsu, sc[j][e])), bc[j][e]));
          z = __fadd_rn(__fmul_rn(p.w, z), __fmul_rn(w1, zu));
        }
        zrow[c] = __fdiv_rn(z, p.temp);
      }
  }
}

// ---- the tail launch: K5, and K6's second launch ---------------------------

constexpr int kTailRows = 8;                // (frame, lane) rows a block, a warp each
constexpr int kTailThreads = 32 * kTailRows;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// f(el, value) for each element of the span src[0, n_el): the elements
// before its first 16-byte boundary and after its last one a thread each,
// the rest a 16-byte load each, two loads a thread in flight.
template <typename T, typename F>
__device__ void for_span(const T* src, long long n_el, F f) {
  constexpr int kPer = 16 / sizeof(T);
  const int lead = (int)min(
      (long long)((kPer - (reinterpret_cast<uintptr_t>(src) / sizeof(T)) % kPer) % kPer), n_el);
  const long long nv = (n_el - lead) / kPer;
  const int rest = (int)(n_el - lead - kPer * nv);
  if ((int)threadIdx.x < lead) f(threadIdx.x, to_float(src[threadIdx.x]));
  if ((int)threadIdx.x < rest) {
    const long long el = lead + kPer * nv + threadIdx.x;
    f(el, to_float(src[el]));
  }
  const uint4* v = reinterpret_cast<const uint4*>(src + lead);
  for (long long i0 = threadIdx.x; i0 < nv; i0 += 2 * blockDim.x) {
    uint4 w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (i0 + j * blockDim.x < nv) w[j] = __ldcg(v + i0 + j * blockDim.x);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long i = i0 + j * blockDim.x;
      if (i >= nv) continue;
      const uint32_t ws[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        float x;
        if (sizeof(T) == 4)
          x = __uint_as_float(ws[e]);
        else
          x = __uint_as_float(e & 1 ? ws[e >> 1] & 0xffff0000u : ws[e >> 1] << 16);
        f(lead + kPer * i + e, x);
      }
    }
  }
}

// 8 consecutive (frame, lane) rows of the (bs, L, n) grid: their tempered,
// combined logits into shared memory, then the tail. kF32: from K6's
// scratch (already combined and tempered); else K5: from the bf16 head
// logits, the cond span, then the uncond span combined with it and tempered.
template <bool kF32>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const void* __restrict__ src, int bs, int rows, float w, float temp, Tail p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const int K = p.K, s_stride = ((K + 7) / 8) * 8 + 4;
  const long long total = (long long)bs * p.L * p.n_lanes;       // rows of a CFG half
  const long long r0 = (long long)blockIdx.x * kTailRows;
  const int n_rows = (int)min((long long)kTailRows, total - r0);
  const long long n_el = (long long)n_rows * K;
  auto at = [&](long long el) {
    const int r = (int)(el / K);
    return S + r * s_stride + (int)(el - (long long)r * K);
  };
  if (kF32) {
    for_span(static_cast<const float*>(src) + r0 * K, n_el,
             [&](long long el, float v) { *at(el) = v; });
  } else {
    const __nv_bfloat16* logits = static_cast<const __nv_bfloat16*>(src);
    const bool cfg2 = rows == 2 * bs;
    const float w1 = __fsub_rn(1.f, w);
    for_span(logits + r0 * K, n_el, [&](long long el, float z) {
      *at(el) = cfg2 ? z : __fdiv_rn(z, temp);
    });
    if (cfg2) {
      __syncthreads();
      for_span(logits + (total + r0) * K, n_el, [&](long long el, float zu) {
        float* o = at(el);
        *o = __fdiv_rn(__fadd_rn(__fmul_rn(w, *o), __fmul_rn(w1, zu)), temp);
      });
    }
  }
  __syncthreads();
  tail_rows(S, s_stride, n_rows, r0, 1, p, threadIdx.x >> 5, threadIdx.x & 31, kTailRows);
}

long long kernel_launches = 0;          // kernels this library has launched

template <bool kF32>
cudaError_t launch_tail(const void* src, int bs, int rows, float w, float temp, const Tail& p,
                        cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTailRows * (kMaxK + 12) * 4);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = (size_t)kTailRows * (((p.K + 7) / 8) * 8 + 4) * 4;
  const long long n_rows = (long long)bs * p.L * p.n_lanes;
  if ((n_rows + kTailRows - 1) / kTailRows > 0x7fffffffll) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_rows + kTailRows - 1) / kTailRows));
  tail_kernel<kF32><<<grid, kTailThreads, smem, st>>>(src, bs, rows, w, temp, p);
  ++kernel_launches;
  return cudaGetLastError();
}

}  // namespace

extern "C" int mars5_heads_diffusion_tail(const void* x8, const void* xs, const void* q,
                                          const void* s, const void* b, const void* u0,
                                          const void* xt, const void* scal, void* out,
                                          void* z, int bs, int rows, int L, int n_lanes, int K,
                                          int D, float w, float temp, int frame_blocks,
                                          int class_tiles, int stages, int smem, void* stream) {
  if (bs <= 0 || L <= 0 || n_lanes <= 0 || n_lanes > 65535 || bs > 65535 || K <= 0 ||
      K > kMaxK || D <= 0 || D % kSlice || (rows != bs && rows != 2 * bs) ||
      frame_blocks * kFrames < L || class_tiles * kClassTile < K || stages < 2 ||
      smem < (D / kSlice + stages) * kTileBytes + 8 * (2 * stages + 1) + 1024)
    return (int)cudaErrorInvalidValue;
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(heads_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  CUtensorMap ta, tq;
  if (!encode_map_s8_3d(&ta, x8, rows, L, D, 8) || !encode_map_s8_3d(&tq, q, n_lanes, K, D, 64))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemmArgs p{static_cast<const float*>(xs), static_cast<const float*>(s),
             static_cast<const float*>(b), static_cast<float*>(z), bs, rows, L, n_lanes, K, D,
             class_tiles, stages, w, temp};
  heads_gemm_kernel<<<dim3(frame_blocks, n_lanes, bs), kGemmThreads, smem, st>>>(ta, tq, p);
  ++kernel_launches;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Tail t{static_cast<const float*>(u0), static_cast<const long long*>(xt),
               static_cast<const float*>(scal), static_cast<long long*>(out), L, n_lanes, K};
  return (int)launch_tail<true>(z, bs, rows, w, temp, t, st);
}

extern "C" int mars5_diffusion_tail(const void* logits, const void* u0, const void* xt,
                                    const void* scal, void* out, int bs, int rows, int L,
                                    int n_lanes, int K, float w, float temp, void* stream) {
  if (bs <= 0 || L <= 0 || n_lanes <= 0 || n_lanes > 65535 || bs > 65535 || K <= 0 ||
      K > kMaxK || (rows != bs && rows != 2 * bs))
    return (int)cudaErrorInvalidValue;
  const Tail p{static_cast<const float*>(u0), static_cast<const long long*>(xt),
               static_cast<const float*>(scal), static_cast<long long*>(out), L, n_lanes, K};
  return (int)launch_tail<false>(logits, bs, rows, w, temp, p, static_cast<cudaStream_t>(stream));
}

// Kernels launched by this library so far (K6: two a call, K5: one).
extern "C" long long mars5_diffusion_tail_kernel_launches() { return kernel_launches; }
