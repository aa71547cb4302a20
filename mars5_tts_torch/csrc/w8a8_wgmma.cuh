// The W8A8 GEMM of the NAR decoder's per-layer sites for Hopper (sm_90a):
// a per-row prologue kernel and a TMA-fed, warp-specialised wgmma s8 GEMM.
// nar_fused.cu chains them into K3 fused_linear and K4 fused_ffn, nar_mega.cu
// into the seven GEMM sites of each layer of K9 mega_decoder_stack.
//
// Prologue, w8a8_prologue<kLN, kChunks>: one warp a row of x (M, K) bf16
//   row-major reads the row once into registers (4 values a lane per 128
//   columns, kept as packed bf16, kChunks * 128 >= K: 2,400 rows of 3,072 fit
//   on the card at once), takes the LayerNorm statistics when kLN (the LN
//   vectors, bf16 or f32, read once a block into shared memory while the rows
//   load), then the row's amax, and writes the int8 row and its f32 scale to
//   scratch: q (M, K) int8 row-major, xs (M,) f32.
//
// GEMM, gemm<kMode, kBN, kBf16Bias> (w8a8_wgmma_gemm: mode 0, its bias bf16
// or f32; w8a8_wgmma_swiglu: mode 1; launched by launch_gemm0 / launch_swiglu):
//   mode 0: out = bf16(acc * (xs * s) [+ bias]) [+ residual]
//   mode 1: u = bf16(bf16(silu(wo)) * vo), wo / vo = bf16(acc * (xs * s))
//   with acc the exact int32 product of q (M, K) and W (N, K), both K-major.
//   - A CTA tile is 128 rows x kBN B rows (128 or 256, the host's choice):
//     two consumer warpgroups of 64 rows run wgmma.m64n{kBN}k32.s32.s8.s8, A
//     and B from shared memory. In mode 1 the kBN B rows are kBN / 2 W rows
//     and the same rows of V, so a thread holds w (fragment column j) and v
//     (column j + kBN / 2) of one u column.
//   - One producer thread loads 128-deep k slices of A and B with TMA
//     (2-D maps, 128-byte swizzle, zero fill past M and N) into a ring of
//     6 (kBN 128) or 4 (kBN 256) stages of 32 or 48 KB, each with a full and
//     an empty mbarrier; its warpgroup gives its registers to the consumers
//     (setmaxnreg 40 / 232).
//   - Persistent: a CTA a SM walks the tiles t = blockIdx.x + i * gridDim.x
//     (row block t / tiles_n, column block t % tiles_n); the producer loads
//     the next tile's slices while the consumers run this tile's epilogue.
//   - The consumers keep one wgmma group in flight: the products of slice i
//     are issued before slice i - 1's stage is handed back.
//   - The epilogue runs on the accumulators in registers; rows past M and
//     columns past N are not written. Its scale, bias and residual loads go
//     through the read-only path in batches ahead of the stores (loads that
//     waited on each store left a 128 x 128 tile's epilogue latency-bound).
//
// Grouped mode (the TPU kernels' _qdot with groups > 1; kGrouped prologue,
// kG 1 or 2 GEMM, 128-wide tiles): the prologue writes a scale a (row, group
// of gsize columns), xs (M, G), from each 32-column segment's amax; the
// consumers flush the int32 accumulator at each group's last 32-deep wgmma
// step (several flushes a 128-deep stage for gsize 32 or 64, one every
// gsize / 128 stages above) into an f32 sum, (float(acc) * xs[row, g]) *
// sg[g, col] (kG 1, weight scales (G, N)) or float(acc) * xs[row, g] (kG
// 2, per-row weight scales, applied after the sum), in group order; the
// epilogue then adds the bias, casts and adds the residual as above.
//
// Numerics (those of the twins and the TPU kernels): LN in f32 (mean, then
// the mean of squared deviations, (x - mean) * (1 / sqrt(var + eps)), * w +
// b), rounded to bf16, with the two means summed in f64 and rounded once
// (the same f32 value in any order) and a correctly rounded 1 / sqrt; xs =
// max(amax, 1e-8) / 127 and q = rint(x / xs) clipped to +-127, by true
// division; the int32 product is exact; the rescale acc * (xs * s), the bias
// add in f32, the bf16 cast, then the residual added in bf16. Products and
// sums use __fmul_rn / __fadd_rn, so no FMA contraction rounds differently
// from the twins.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using namespace mars5;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- prologue --------------------------------------------------------------

constexpr int kRowWarps = 8;             // rows a prologue block
constexpr int kMaxK = 3072;

// The four bf16 of ``r`` as floats (exact: a bf16 is the high half of an f32).
__device__ __forceinline__ void unpack4(uint2 r, float* v) {
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// Four floats that are bf16 values (low halves zero) packed as unpack4 reads them.
__device__ __forceinline__ uint2 pack4(const float* v) {
  return make_uint2((__float_as_uint(v[0]) >> 16) | __float_as_uint(v[1]),
                    (__float_as_uint(v[2]) >> 16) | __float_as_uint(v[3]));
}

// Element i of a bias vector, bf16 or f32 (bf16 to f32 is exact).
template <bool kBf16>
__device__ __forceinline__ float vec_at(const void* p, int i) {
  if (kBf16) return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i));
  return __ldg(static_cast<const float*>(p) + i);
}

template <bool kLN, int kChunks, bool kGrouped>
__global__ void __launch_bounds__(kRowWarps * 32)
w8a8_prologue(const __nv_bfloat16* __restrict__ x, const void* ln_w, const void* ln_b,
              int vec_bf16, float eps, int8_t* __restrict__ q, float* __restrict__ xs_out, int M,
              int K, int gsize) {
  // the block's LN vectors, loaded once while the rows are in flight
  __shared__ float4 lnp[2][kLN ? kChunks * 32 : 1];
  // kGrouped: each warp's 32-column maxima, then its row's group scales
  __shared__ float seg_sh[kGrouped ? kRowWarps : 1][kGrouped ? kMaxK / 32 : 1];
  __shared__ float xs_sh[kGrouped ? kRowWarps : 1][kGrouped ? kMaxK / 32 : 1];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const bool live = row < M;
  const int nch = K / 128;
  // the row stays in registers as bf16, 4 a lane per 128 columns: x, then the
  // LN'd values (rounded to bf16 by the contract, so packing them is exact)
  uint2 r[kChunks];
  float v[4];
  if (live) {
    const __nv_bfloat16* xr = x + (long long)row * K + lane * 4;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nch) r[c] = *reinterpret_cast<const uint2*>(xr + c * 128);
  }
  if (kLN) {
    for (int i = threadIdx.x; i < 2 * nch * 32; i += kRowWarps * 32) {
      const int which = i >= nch * 32, k4 = i - which * nch * 32;
      const void* src = which ? ln_b : ln_w;
      if (vec_bf16) {
        unpack4(static_cast<const uint2*>(src)[k4], v);
        lnp[which][k4] = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        lnp[which][k4] = static_cast<const float4*>(src)[k4];
      }
    }
    __syncthreads();
  }
  if (!live) return;
  if (kLN) {
    // f64 sums rounded to f32 once: four partial sums a lane, the order does
    // not show in the f32 result (as in the twins)
    double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nch) {
        unpack4(r[c], v);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += (double)v[j];
      }
    const float mean = __fdiv_rn((float)warp_sum((s[0] + s[1]) + (s[2] + s[3])), (float)K);
    double sq[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nch) {
        unpack4(r[c], v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = __fsub_rn(v[j], mean);
          sq[j] += (double)__fmul_rn(d, d);
        }
      }
    const float var = __fdiv_rn((float)warp_sum((sq[0] + sq[1]) + (sq[2] + sq[3])), (float)K);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nch) {
        const float4 w = lnp[0][c * 32 + lane], b = lnp[1][c * 32 + lane];
        const float wj[4] = {w.x, w.y, w.z, w.w}, bj[4] = {b.x, b.y, b.z, b.w};
        unpack4(r[c], v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = __fmul_rn(__fsub_rn(v[j], mean), rstd);
          v[j] = bf16_round(__fadd_rn(__fmul_rn(y, wj[j]), bj[j]));
        }
        r[c] = pack4(v);
      }
  }
  int8_t* qr = q + (long long)row * K + lane * 4;
  if (kGrouped) {
    // groups of gsize columns (a multiple of 32 dividing K): the maximum of
    // each 32-column segment (8 lanes of a chunk), then each group's over
    // its segments; the scales go out as xs (M, G) row-major
    const int w = threadIdx.x >> 5, G = K / gsize, nseg = gsize / 32;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nch) {
        unpack4(r[c], v);
        float m = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if ((lane & 7) == 0) seg_sh[w][c * 4 + (lane >> 3)] = m;
      }
    __syncwarp();
    for (int g = lane; g < G; g += 32) {
      float m = 0.f;
      for (int i = 0; i < nseg; ++i) m = fmaxf(m, seg_sh[w][g * nseg + i]);
      const float xs = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
      xs_sh[w][g] = xs;
      xs_out[(long long)row * G + g] = xs;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c < nch) {
        unpack4(r[c], v);
        const float xs = xs_sh[w][(c * 128 + lane * 4) / gsize];
        uint32_t packed = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = max(-127, min(127, __float2int_rn(__fdiv_rn(v[j], xs))));
          packed |= (uint32_t)(uint8_t)(int8_t)qi << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(qr + c * 128) = packed;
      }
    return;
  }
  float am[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (c < nch) {
      unpack4(r[c], v);
#pragma unroll
      for (int j = 0; j < 4; ++j) am[j] = fmaxf(am[j], fabsf(v[j]));
    }
  const float amax = warp_max(fmaxf(fmaxf(am[0], am[1]), fmaxf(am[2], am[3])));
  const float xs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (c < nch) {
      unpack4(r[c], v);
      uint32_t packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = max(-127, min(127, __float2int_rn(__fdiv_rn(v[j], xs))));
        packed |= (uint32_t)(uint8_t)(int8_t)qi << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(qr + c * 128) = packed;
    }
  if (lane == 0) xs_out[row] = xs;
}

template <bool kLN, int kChunks, bool kGrouped = false>
cudaError_t launch_prologue_k(const __nv_bfloat16* x, const void* ln_w, const void* ln_b,
                              int vec_bf16, float eps, int8_t* q, float* xs, int M, int K,
                              cudaStream_t st, int gsize = 0) {
  const dim3 grid((M + kRowWarps - 1) / kRowWarps);
  w8a8_prologue<kLN, kChunks, kGrouped><<<grid, kRowWarps * 32, 0, st>>>(
      x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, gsize);
  return cudaGetLastError();
}

// The prologue over x (M, K); LN when ln_w is given. Rows of up to 1,024
// columns keep 32 values a lane, longer ones (to kMaxK) 96.
cudaError_t launch_prologue(const __nv_bfloat16* x, const void* ln_w, const void* ln_b,
                            int vec_bf16, float eps, int8_t* q, float* xs, int M, int K,
                            cudaStream_t st) {
  const bool ln = ln_w != nullptr;
  if (K <= 1024)
    return ln ? launch_prologue_k<true, 8>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, st)
              : launch_prologue_k<false, 8>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, st);
  return ln ? launch_prologue_k<true, kMaxK / 128>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, st)
            : launch_prologue_k<false, kMaxK / 128>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K,
                                                    st);
}

// The prologue with per-(row, group of gsize columns) scales, xs (M, K / gsize).
cudaError_t launch_prologue_grouped(const __nv_bfloat16* x, const void* ln_w, const void* ln_b,
                                    int vec_bf16, float eps, int8_t* q, float* xs, int M, int K,
                                    int gsize, cudaStream_t st) {
  const bool ln = ln_w != nullptr;
  if (K <= 1024)
    return ln ? launch_prologue_k<true, 8, true>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, st,
                                                 gsize)
              : launch_prologue_k<false, 8, true>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, st,
                                                  gsize);
  return ln ? launch_prologue_k<true, kMaxK / 128, true>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M,
                                                         K, st, gsize)
            : launch_prologue_k<false, kMaxK / 128, true>(x, ln_w, ln_b, vec_bf16, eps, q, xs, M,
                                                          K, st, gsize);
}

// ---- GEMM ------------------------------------------------------------------

constexpr int kBM = 128;                 // rows a tile: two consumer warpgroups of 64
constexpr int kBK = 128;                 // k depth of a stage: one 128-byte swizzle row
constexpr int kWarpgroup = 128;
constexpr int kGemmThreads = 3 * kWarpgroup;         // two consumers, one producer
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 64 K
constexpr int kTileA = kBM * kBK;        // bytes

// A tile of kBN B rows (128 or 256; mode 1: half W, half V): a stage holds
// 128 rows of A and the kBN rows, and the ring as many stages as fit in
// 192 KB (6 or 4).
template <int kBN>
struct Ring {
  static constexpr int kTileB = kBN * kBK;
  static constexpr int kStageBytes = kTileA + kTileB;
  static constexpr int kStages = (192 * 1024) / kStageBytes;
  static constexpr int kOffBars = kStages * kStageBytes;
  static constexpr int kSmem = kOffBars + 2 * kStages * 8 + 1024;   // + alignment slack
};

struct Epilogue {
  const float* xs;       // (M,) row scales of A; grouped: (M, G) row-major
  const float* ws;       // (N,) scales of W; kG 1: (G, N) row-major
  const float* vs;       // mode 1: (N,) scales of V; kG 1: (G, N)
  const void* bias;      // mode 0: (N,) bf16 or f32 (the kernel's kBf16Bias), or null
  const __nv_bfloat16* res;   // mode 0: (M, N) row-major residual, or null
  __nv_bfloat16* out;    // (M, N) row-major
  int M, N, K;           // N: output columns (mode 1: u columns, F)
  int gsize = 0;         // grouped kernels: K columns a group (a multiple of 32), G = K / gsize
};

template <int kBN>
__device__ __forceinline__ void wgmma_s8(int* acc, uint64_t da, uint64_t db, int accumulate) {
  if (kBN == 128)
    wgmma_m64n128k32_s8(acc, da, db, accumulate);
  else
    wgmma_m64n256k32_s8(acc, da, db, accumulate);
}

// The f32 value of accumulator element i before the bias: the rescaled int32
// product acc * (xs * ws) (kG 0), or the sum of the groups' partials (kG 1),
// times W's row scale (kG 2).
template <int kG>
__device__ __forceinline__ float rescaled(const int* acc, const float* sum, int i, float xs,
                                          float ws) {
  if constexpr (kG == 0) return __fmul_rn((float)acc[i], __fmul_rn(xs, ws));
  else if constexpr (kG == 1) return sum[i];
  else return __fmul_rn(sum[i], ws);
}

// The k loop of one tile in a grouped mode (kG 1 or 2, see gemm), for the
// consumer thread of rows r0 and r0 + 8, columns n0 + 8 j + 2 q4 + {0, 1}.
// The wgmma steps (32 deep) of each gsize-column group accumulate in acc; at
// the group's last step the consumer waits for them and adds the group's
// partial to sum: (float(acc) * xs[row, g]) * sg[g, col] (kG 1) or
// float(acc) * xs[row, g] (kG 2), summed in group order from the first, as
// the twins' _qdot does. A stage goes back to the producer once its
// products are done. One wgmma group in flight at a time: the flushes need
// the int32 sums, so the grouped modes give up the overlap of the slice
// before with the next.
template <int kMode, int kBN, int kG>
__device__ __forceinline__ void grouped_mainloop(int* acc, float* sum, uint32_t base,
                                                 uint32_t full, uint32_t empty, int& s,
                                                 int& phase, int wg, int lane, int r0, int n0,
                                                 int q4, const Epilogue& p) {
  using R = Ring<kBN>;
  const int n_k = p.K / kBK, G = p.K / p.gsize;
  const bool live0 = r0 < p.M, live1 = r0 + 8 < p.M;
  for (int kc = 0; kc < n_k; ++kc) {
    mbar_wait(full + 8 * s, phase);
    const uint32_t a = base + s * R::kStageBytes + wg * 64 * kBK;
    const uint32_t b = base + s * R::kStageBytes + kTileA;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const int k0 = kc * kBK + kk * 32;
      const bool flush = (k0 + 32) % p.gsize == 0;
      fence_regs<kBN / 2>(acc);
      wgmma_fence();
      wgmma_s8<kBN>(acc, wgmma_desc_sw128(a + 32 * kk, 0, 1024),
                    wgmma_desc_sw128(b + 32 * kk, 0, 1024), k0 % p.gsize != 0);
      if (!flush && kk != kBK / 32 - 1) continue;
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kBN / 2>(acc);
      if (!flush) continue;
      const int gi = (k0 + 32) / p.gsize - 1;
      const float xa = live0 ? __ldg(p.xs + (long long)r0 * G + gi) : 0.f;
      const float xb = live1 ? __ldg(p.xs + (long long)(r0 + 8) * G + gi) : 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        // mode 1: fragment groups j < kBN / 16 are W's columns, the rest V's
        const bool is_v = kMode == 1 && j >= kBN / 16;
        const int col = n0 + 8 * (is_v ? j - kBN / 16 : j) + 2 * q4;
        float w2[2] = {0.f, 0.f};
        if (kG == 1 && col < p.N) {
          const float* sg = (is_v ? p.vs : p.ws) + (long long)gi * p.N + col;
          w2[0] = __ldg(sg);
          w2[1] = __ldg(sg + 1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float part = __fmul_rn((float)acc[i], h ? xb : xa);
            if (kG == 1) part = __fmul_rn(part, w2[e]);
            sum[i] = gi == 0 ? part : __fadd_rn(sum[i], part);
          }
      }
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (++s == R::kStages) s = 0, phase ^= 1;
  }
}

// kG: 0 one scale a row of A and of W; grouped (gsize-column groups of K,
// A's scales (M, G)), 1 with W's scales (G, N) too, 2 with W's per row.
template <int kMode, int kBN, bool kBf16Bias, int kG = 0>
__device__ __forceinline__ void gemm(const CUtensorMap* ta, const CUtensorMap* tw,
                                     const CUtensorMap* tv, const Epilogue& p) {
  using R = Ring<kBN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + R::kOffBars, empty = full + 8 * R::kStages;
  constexpr int kCols = kMode == 0 ? kBN : kBN / 2;    // output columns a tile
  const int tiles_n = (p.N + kCols - 1) / kCols;
  const int tiles = ((p.M + kBM - 1) / kBM) * tiles_n;
  const int n_k = p.K / kBK;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kWarpgroup / 32);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: one thread loads, the rest leave
    warpgroup_regs_dec<kProducerRegs>();
    if (threadIdx.x != 2 * kWarpgroup) return;
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * kCols;
      for (int kc = 0; kc < n_k; ++kc) {
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t a = base + s * R::kStageBytes, b = a + kTileA, bar = full + 8 * s;
        mbar_arrive_expect_tx(bar, R::kStageBytes);
        tma_load_2d(a, ta, bar, kc * kBK, m0);
        tma_load_2d(b, tw, bar, kc * kBK, n0);
        if (kMode == 1) tma_load_2d(b + R::kTileB / 2, tv, bar, kc * kBK, n0);
        if (++s == R::kStages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
  warpgroup_regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x % kWarpgroup, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  int acc[kBN / 2];
  float sum[kBN / 2];                   // grouped: the f32 sum of the groups' rescaled partials
  int s = 0, phase = 0, prev = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * kCols;
    if constexpr (kG != 0) {
      grouped_mainloop<kMode, kBN, kG>(acc, sum, base, full, empty, s, phase, wg, lane,
                                       m0 + wg * 64 + warp * 16 + g, n0, q4, p);
    } else {
    for (int kc = 0; kc < n_k; ++kc) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t a = base + s * R::kStageBytes + wg * 64 * kBK;
      const uint32_t b = base + s * R::kStageBytes + kTileA;
      fence_regs<kBN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8<kBN>(acc, wgmma_desc_sw128(a + 32 * kk, 0, 1024),
                      wgmma_desc_sw128(b + 32 * kk, 0, 1024), kc > 0 || kk > 0);
      wgmma_commit();
      fence_regs<kBN / 2>(acc);
      wgmma_wait<1>();                    // the products of the slice before are done
      if (kc > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == R::kStages) s = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs<kBN / 2>(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    }

    // ---- epilogue: rows g and g + 8 of this warp's 16. The loads it needs
    // (scales, bias, residual) are read-only (ld.global.nc), so each batch
    // of kBatch column groups issues all of them before its first store.
    const int r0 = m0 + wg * 64 + warp * 16 + g;
    const bool live[2] = {r0 < p.M, r0 + 8 < p.M};
    float xs[2] = {0.f, 0.f};
    __nv_bfloat16* orow[2];
    const __nv_bfloat16* rrow[2] = {nullptr, nullptr};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      orow[h] = p.out + (long long)(r0 + 8 * h) * p.N;
      if (live[h]) {
        if (kG == 0) xs[h] = __ldg(p.xs + r0 + 8 * h);
        if (kMode == 0 && p.res != nullptr) rrow[h] = p.res + (long long)(r0 + 8 * h) * p.N;
      }
    }
    constexpr int kGroups = kMode == 0 ? kBN / 8 : kBN / 16;   // 8-column groups a thread
    constexpr int kBatch = 8;
#pragma unroll
    for (int j0 = 0; j0 < kGroups; j0 += kBatch) {
      float sa[kBatch][2], sb[kBatch][2];      // mode 0: ws, bias; mode 1: ws, vs
      __nv_bfloat162 rv[2][kBatch];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * q4;
        const bool in = col < p.N;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // kG 1: W's (and V's) scales were applied group by group
          sa[jj][e] = in && kG != 1 ? __ldg(p.ws + col + e) : 0.f;
          if (kMode == 0)
            sb[jj][e] = in && p.bias != nullptr ? vec_at<kBf16Bias>(p.bias, col + e) : 0.f;
          else
            sb[jj][e] = kG != 1 ? __ldg(p.vs + col + e) : 0.f;    // N is a multiple of kCols
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (kMode == 0 && in && rrow[h] != nullptr)
            rv[h][jj] = __ldg(reinterpret_cast<const __nv_bfloat162*>(rrow[h] + col));
      }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * q4;
        if (col >= p.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live[h]) continue;
          __nv_bfloat16 o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (kMode == 0) {
              float y = rescaled<kG>(acc, sum, 4 * j + 2 * h + e, xs[h], sa[jj][e]);
              if (p.bias != nullptr) y = __fadd_rn(y, sb[jj][e]);
              o[e] = __float2bfloat16_rn(y);
              if (rrow[h] != nullptr)
                o[e] = __float2bfloat16_rn(__fadd_rn(
                    __bfloat162float(e == 0 ? rv[h][jj].x : rv[h][jj].y), __bfloat162float(o[e])));
            } else {
              const float wo = bf16_round(rescaled<kG>(acc, sum, 4 * j + 2 * h + e, xs[h],
                                                       sa[jj][e]));
              const float vo = bf16_round(rescaled<kG>(acc, sum, 4 * (j + kBN / 16) + 2 * h + e,
                                                       xs[h], sb[jj][e]));
              const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-wo)));
              o[e] = __float2bfloat16_rn(__fmul_rn(bf16_round(__fmul_rn(wo, sig)), vo));
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(orow[h] + col) = __halves2bfloat162(o[0], o[1]);
        }
      }
    }
  }
}

template <int kBN, bool kBf16Bias, int kG = 0>
__global__ void __launch_bounds__(kGemmThreads, 1)
w8a8_wgmma_gemm(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                Epilogue p) {
  gemm<0, kBN, kBf16Bias, kG>(&ta, &tw, &tw, p);
}
template <int kBN, int kG = 0>
__global__ void __launch_bounds__(kGemmThreads, 1)
w8a8_wgmma_swiglu(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tv, Epilogue p) {
  gemm<1, kBN, false, kG>(&ta, &tw, &tv, p);
}

// ---- host launchers ----------------------------------------------------------

// Launches a GEMM kernel with kBN-wide tiles, its dynamic shared memory
// (above 48 KB) allowed once a device.
template <auto kKernel, int kBN, typename... Args>
cudaError_t launch_gemm(int grid, cudaStream_t st, Args... args) {
  static std::atomic<unsigned> smem_set{0};   // one bit a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !(smem_set.load() & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kKernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<kBN>::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 32) smem_set.fetch_or(1u << dev);
  }
  kKernel<<<grid, kGemmThreads, Ring<kBN>::kSmem, st>>>(args...);
  return cudaGetLastError();
}

// The mode-0 GEMM with bn-wide tiles and a bf16 or f32 bias.
inline cudaError_t launch_gemm0(int bn, bool bf16_bias, int grid, cudaStream_t st,
                                const CUtensorMap& ta, const CUtensorMap& tw, const Epilogue& p) {
  if (bn == 128)
    return bf16_bias ? launch_gemm<w8a8_wgmma_gemm<128, true>, 128>(grid, st, ta, tw, p)
                     : launch_gemm<w8a8_wgmma_gemm<128, false>, 128>(grid, st, ta, tw, p);
  return bf16_bias ? launch_gemm<w8a8_wgmma_gemm<256, true>, 256>(grid, st, ta, tw, p)
                   : launch_gemm<w8a8_wgmma_gemm<256, false>, 256>(grid, st, ta, tw, p);
}

// The grouped mode-0 GEMM (128-wide tiles: the f32 sums and the int32
// accumulators together fit a consumer's registers only there), W's scales
// (G, N) (w_grouped) or (N,).
inline cudaError_t launch_gemm0_grouped(bool w_grouped, bool bf16_bias, int grid,
                                        cudaStream_t st, const CUtensorMap& ta,
                                        const CUtensorMap& tw, const Epilogue& p) {
  if (w_grouped)
    return bf16_bias ? launch_gemm<w8a8_wgmma_gemm<128, true, 1>, 128>(grid, st, ta, tw, p)
                     : launch_gemm<w8a8_wgmma_gemm<128, false, 1>, 128>(grid, st, ta, tw, p);
  return bf16_bias ? launch_gemm<w8a8_wgmma_gemm<128, true, 2>, 128>(grid, st, ta, tw, p)
                   : launch_gemm<w8a8_wgmma_gemm<128, false, 2>, 128>(grid, st, ta, tw, p);
}

// The grouped mode-1 GEMM, 128-wide tiles (64 rows of W, 64 of V).
inline cudaError_t launch_swiglu_grouped(bool w_grouped, int grid, cudaStream_t st,
                                         const CUtensorMap& ta, const CUtensorMap& tw,
                                         const CUtensorMap& tv, const Epilogue& p) {
  return w_grouped ? launch_gemm<w8a8_wgmma_swiglu<128, 1>, 128>(grid, st, ta, tw, tv, p)
                   : launch_gemm<w8a8_wgmma_swiglu<128, 2>, 128>(grid, st, ta, tw, tv, p);
}

// The mode-1 (SwiGLU) GEMM with bn-wide tiles: bn / 2 rows of W and of V.
inline cudaError_t launch_swiglu(int bn, int grid, cudaStream_t st, const CUtensorMap& ta,
                                 const CUtensorMap& tw, const CUtensorMap& tv, const Epilogue& p) {
  return bn == 128 ? launch_gemm<w8a8_wgmma_swiglu<128>, 128>(grid, st, ta, tw, tv, p)
                   : launch_gemm<w8a8_wgmma_swiglu<256>, 256>(grid, st, ta, tw, tv, p);
}

}  // namespace
