// The W8A8 GEMM tile of the NAR decoder for Hopper (sm_90a), shared by K3/K4
// (nar_fused.cu) and K9 (nar_mega.cu).
//
// One kernel, w8a8_gemm_kernel<kLN, kMode>:
//   mode 0: out = bf16(rescale(quant(A) . W^T) [+ bias]) [+ residual]
//   mode 1: u = bf16(bf16(silu(wo)) * vo), wo/vo = bf16(rescale(quant(A) . W^T / V^T))
//   with A = the x rows, LayerNorm'd first when kLN; or, when Args.a8 is
//   given, rows already quantized to int8 with their scales.
//
//   x (M, K) bf16 row-major; W/V (N, K) int8 row-major with f32 per-row
//   scales; bias (N,) f32; residual and out (M, N) bf16 (out may be the
//   residual itself: each element is read and written by one thread).
//
// Numerics (those of the TPU kernels): LN in f32 (mean, then the mean of
// squared deviations, (x - mean) / sqrt(var + eps), * w + b), rounded to
// bf16 and back, with the two means summed in f64 and rounded once (the same
// f32 value in any order, as in the plain twins) and the inverse deviation a
// correctly rounded 1 / sqrt. xs = max(amax, 1e-8) / 127 and q = rint(x / xs) clipped to +-127
// (round half to even, true division); the int32 product is exact; the
// rescale acc * (xs * s), the bias add in f32, the bf16 cast, then the
// residual added in bf16. Products and sums of the epilogue use __fmul_rn /
// __fadd_rn so the compiler never contracts them into an FMA with another
// rounding than the plain version's.
//
// Design: LN and the per-row amax need whole rows, so a block owns 64 rows:
// it normalises and quantises them once into shared memory (int8, rows
// padded by 16 bytes so fragment loads are free of bank conflicts) and then
// walks its share of the output columns in 64-row weight tiles, streamed 128
// k-deep through a two-stage cp.async buffer. 4 warps x 16 rows run
// mma.sync.m16n8k32 (s8 x s8 -> s32) over all 64 tile rows. No wgmma, TMA or
// warp specialisation yet.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kBM = 64;                 // rows per block: 4 warps x 16
constexpr int kBN = 64;                 // weight rows per tile
constexpr int kKC = 128;                // k depth of a staged weight chunk
constexpr int kThreads = 128;
constexpr int kBStride = kKC + 16;      // padded weight row in shared memory (bytes)
constexpr int kMaxK = 3072;
constexpr int kSmemB = 2 * kBN * kBStride;
constexpr int kMaxSmem = kBM * (kMaxK + 16) + kSmemB + kBM * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

struct Args {
  const __nv_bfloat16* x;
  const float* ln_w;
  const float* ln_b;
  const int8_t* wq;
  const float* ws;
  const int8_t* vq;
  const float* vs;
  const float* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int M, N, K, tiles_per_block;
  float eps;
  // K9 only: an A operand given already quantized (a8 (M, K) int8 with row
  // scales a8s)
  const int8_t* a8;
  const float* a8s;
};

// Row r of the block, as the activation A (LN'd and bf16-rounded when kLN):
// element c of a row given its statistics.
template <bool kLN>
__device__ __forceinline__ float a_value(float xv, int c, float mean, float rstd,
                                         const Args& p) {
  if (!kLN) return xv;
  const float y = __fmul_rn(__fsub_rn(xv, mean), rstd);
  return bf16_round(__fadd_rn(__fmul_rn(y, p.ln_w[c]), p.ln_b[c]));
}

// One warp quantises one row of x into the block's int8 A tile.
template <bool kLN>
__device__ void quantize_row(const Args& p, int row, int8_t* arow, float* xs_out, int lane) {
  const int K = p.K;
  if (row >= p.M) {
    for (int c = lane * 8; c < K; c += 256)
      *reinterpret_cast<uint2*>(arow + c) = make_uint2(0u, 0u);
    if (lane == 0) *xs_out = 0.f;
    return;
  }
  const __nv_bfloat16* xr = p.x + (long long)row * K;
  float v[8];
  float mean = 0.f, rstd = 1.f;
  if (kLN) {
    // f64 sums rounded to f32 once: the same value in any order
    double s = 0.0;
    for (int c = lane * 8; c < K; c += 256) {
      load8(xr + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += (double)v[j];
    }
    mean = __fdiv_rn((float)warp_sum(s), (float)K);
    double sq = 0.0;
    for (int c = lane * 8; c < K; c += 256) {
      load8(xr + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(v[j], mean);
        sq += (double)__fmul_rn(d, d);
      }
    }
    const float var = __fdiv_rn((float)warp_sum(sq), (float)K);
    rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
  }
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(a_value<kLN>(v[j], c + j, mean, rstd, p)));
  }
  const float xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.f);
  for (int c = lane * 8; c < K; c += 256) {
    load8(xr + c, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int q = __float2int_rn(__fdiv_rn(a_value<kLN>(v[j], c + j, mean, rstd, p), xs));
      q = max(-127, min(127, q));
      packed[j >> 2] |= (uint32_t)(uint8_t)(int8_t)q << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(arow + c) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) *xs_out = xs;
}

// Stage s of the block's walk: weight tile (tile0 + s / n_kc), k chunk
// (s % n_kc), 64 rows x 128 bytes into buffer b.
template <int kMode>
__device__ __forceinline__ void load_stage(const Args& p, int8_t* bs, int tile, int kc) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (kBN * kKC / 16) / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk >> 3, col = (chunk & 7) * 16;
    const int8_t* src;
    if (kMode == 0) {
      src = p.wq + (long long)(tile * kBN + r) * p.K;
    } else {  // 32 W rows, then the 32 V rows of the same u columns
      const int j = tile * (kBN / 2) + (r & 31);
      src = (r < 32 ? p.wq : p.vq) + (long long)j * p.K;
    }
    cp_async16(bs + r * kBStride + col, src + kc * kKC + col);
  }
}

template <bool kLN, int kMode>
__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, a_stride = K + 16;
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + kBM * a_stride;                              // 2 stage buffers
  float* xs_s = reinterpret_cast<float*>(Bs + kSmemB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = kMode == 0 ? p.N / kBN : p.N / (kBN / 2);
  const int tile0 = blockIdx.y * p.tiles_per_block;
  const int tile_end = min(tile0 + p.tiles_per_block, n_tiles);
  if (tile0 >= tile_end) return;
  const int n_kc = K / kKC;
  const int stages = (tile_end - tile0) * n_kc;

  // the first weight chunk flies while the block quantises its rows
  load_stage<kMode>(p, Bs, tile0, 0);
  cp_async_commit();
  if (p.a8 != nullptr) {  // rows already quantized: copy them in (zero past M)
    for (int c = threadIdx.x; c < kBM * (K / 16); c += kThreads) {
      const int r = c / (K / 16), col = (c % (K / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < p.M) v = *reinterpret_cast<const int4*>(p.a8 + (long long)(m0 + r) * K + col);
      *reinterpret_cast<int4*>(As + r * a_stride + col) = v;
    }
    if (threadIdx.x < kBM) xs_s[threadIdx.x] = m0 + threadIdx.x < p.M ? p.a8s[m0 + threadIdx.x] : 0.f;
  } else {
    for (int r = warp; r < kBM; r += 4)
      quantize_row<kLN>(p, m0 + r, As + r * a_stride, xs_s + r, lane);
  }

  int acc[kBN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;

  const int8_t* a_lo = As + (warp * 16 + g) * a_stride + 4 * t;
  const int8_t* a_hi = a_lo + 8 * a_stride;

  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      load_stage<kMode>(p, Bs + ((s + 1) & 1) * kBN * kBStride, tile0 + (s + 1) / n_kc,
                        (s + 1) % n_kc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int tile = tile0 + s / n_kc, kc = s % n_kc;
    const int8_t* bbuf = Bs + (s & 1) * kBN * kBStride + g * kBStride + 4 * t;
#pragma unroll
    for (int ks = 0; ks < kKC / 32; ++ks) {
      const int kk = kc * kKC + ks * 32;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(a_lo + kk),
                             *reinterpret_cast<const uint32_t*>(a_hi + kk),
                             *reinterpret_cast<const uint32_t*>(a_lo + kk + 16),
                             *reinterpret_cast<const uint32_t*>(a_hi + kk + 16)};
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const int8_t* bp = bbuf + nt * 8 * kBStride + ks * 32;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(bp),
                               *reinterpret_cast<const uint32_t*>(bp + 16)};
        mma_s8_16832(acc[nt], a, b);
      }
    }

    if (kc == n_kc - 1) {
      // epilogue of this tile: rows g and g + 8 of the warp, two columns each
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = warp * 16 + g + 8 * half, row = m0 + rl;
        const float xs = xs_s[rl];
        if (row < p.M) {
          if (kMode == 0) {
#pragma unroll
            for (int nt = 0; nt < kBN / 8; ++nt) {
              const int col = tile * kBN + nt * 8 + 2 * t;
              __nv_bfloat16 o[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                float y = __fmul_rn((float)acc[nt][2 * half + j], __fmul_rn(xs, p.ws[col + j]));
                if (p.bias != nullptr) y = __fadd_rn(y, p.bias[col + j]);
                o[j] = __float2bfloat16_rn(y);
                if (p.res != nullptr)
                  o[j] = __float2bfloat16_rn(__fadd_rn(
                      __bfloat162float(p.res[(long long)row * p.N + col + j]),
                      __bfloat162float(o[j])));
              }
              *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row * p.N + col) =
                  __halves2bfloat162(o[0], o[1]);
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < kBN / 16; ++nt) {
              const int col = tile * (kBN / 2) + nt * 8 + 2 * t;
              __nv_bfloat16 o[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float wo = bf16_round(
                    __fmul_rn((float)acc[nt][2 * half + j], __fmul_rn(xs, p.ws[col + j])));
                const float vo = bf16_round(__fmul_rn((float)acc[nt + kBN / 16][2 * half + j],
                                                      __fmul_rn(xs, p.vs[col + j])));
                const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-wo)));
                o[j] = __float2bfloat16_rn(__fmul_rn(bf16_round(__fmul_rn(wo, sig)), vo));
              }
              *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row * p.N + col) =
                  __halves2bfloat162(o[0], o[1]);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

// Output tiles each block walks: enough blocks to cover the card twice (the
// rule of ops/kernels/nar_fused.py _tiles_per_block).
inline int tiles_per_block(int m, int n_cols) {
  const int tiles = n_cols / kBN, m_blocks = (m + kBM - 1) / kBM;
  if (tiles <= 0 || m_blocks <= 0) return 1;
  const int want = (264 + m_blocks - 1) / m_blocks;
  const int splits = tiles < (want > 1 ? want : 1) ? tiles : (want > 1 ? want : 1);
  return (tiles + splits - 1) / splits;
}

template <bool kLN, int kMode>
cudaError_t launch(const Args& p, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_gemm_kernel<kLN, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_tiles = kMode == 0 ? p.N / kBN : p.N / (kBN / 2);
  const dim3 grid((p.M + kBM - 1) / kBM,
                  (n_tiles + p.tiles_per_block - 1) / p.tiles_per_block);
  const size_t smem = (size_t)kBM * (p.K + 16) + kSmemB + kBM * 4;
  w8a8_gemm_kernel<kLN, kMode><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
