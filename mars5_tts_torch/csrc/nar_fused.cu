// W8A8 GEMMs of the NAR decoder layer for Hopper (sm_90a): K3 fused_linear
// and K4 fused_ffn.
//
// Replaces the TPU kernels mars5_tts_tpu/ops/pallas/nar_fused.py::_lin_kernel
// (entry fused_linear) and ::_ffn_kernel (entry fused_ffn), groups = 1.
//
// One kernel, mars5_w8a8_gemm, in two modes:
//   mode 0 (K3, and K4's second launch):
//     out = bf16(rescale(quant(A) . W^T) [+ bias]) [+ residual]
//   mode 1 (K4's first launch):
//     u = bf16(bf16(silu(wo)) * vo), wo/vo = bf16(rescale(quant(A) . W^T / V^T))
//   with A = the x rows, LayerNorm'd first when ln_w is given.
//
//   x (M, K) bf16 row-major; W/V (N, K) int8 row-major with f32 per-row
//   scales; bias (N,) f32; residual and out (M, N) bf16.
//
// Numerics (those of the TPU kernels): LN in f32 (mean, then the mean of
// squared deviations, (x - mean) * rsqrt(var + eps), * w + b), rounded to
// bf16 and back; xs = max(amax, 1e-8) / 127 and q = rint(x / xs) clipped to
// +-127 (round half to even, true division); the int32 product is exact;
// the rescale acc * (xs * s), the bias add in f32, the bf16 cast, then the
// residual added in bf16. Products and sums of the epilogue use __fmul_rn /
// __fadd_rn so the compiler never contracts them into an FMA with another
// rounding than the plain version's.
//
// What bounds it here: at the decoder's M = 2400 rows the qkv GEMM is 7.5 G
// int8 MACs over 3 MB of weights, bound by the tensor cores and by weight
// re-reads from L2. LN and the per-row amax need whole rows, so a block owns
// 64 rows: it normalises and quantises them once into shared memory (int8,
// rows padded by 16 bytes so fragment loads are free of bank conflicts) and
// then walks its share of the output columns in 64-row weight tiles,
// streamed 128 k-deep through a two-stage cp.async buffer. 4 warps x 16 rows
// run mma.sync.m16n8k32 (s8 x s8 -> s32) over all 64 tile rows. The TPU
// _ffn_kernel kept the whole (rows x 2F) intermediate in VMEM; the re-quant
// of u needs each row's amax over all F = 3072 columns, and 64 rows of u
// (384 KB bf16) exceed a Hopper block's 227 KB of shared memory, so K4 is
// two launches: mode 1 writes u to device scratch, and mode 0 with K = F
// re-reads each u row whole, takes its amax, quantises and runs lin2 with
// bias and residual. No wgmma, TMA or warp specialisation yet.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                 // rows per block: 4 warps x 16
constexpr int kBN = 64;                 // weight rows per tile
constexpr int kKC = 128;                // k depth of a staged weight chunk
constexpr int kThreads = 128;
constexpr int kBStride = kKC + 16;      // padded weight row in shared memory (bytes)
constexpr int kMaxK = 3072;
constexpr int kSmemB = 2 * kBN * kBStride;
constexpr int kMaxSmem = kBM * (kMaxK + 16) + kSmemB + kBM * 4;

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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
    float s = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      load8(xr + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    mean = warp_sum(s) / (float)K;
    float sq = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      load8(xr + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(v[j], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    rstd = rsqrtf(__fadd_rn(warp_sum(sq) / (float)K, p.eps));
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
  for (int r = warp; r < kBM; r += 4)
    quantize_row<kLN>(p, m0 + r, As + r * a_stride, xs_s + r, lane);

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

extern "C" int mars5_w8a8_gemm(int mode, const void* x, const void* ln_w, const void* ln_b,
                               const void* wq, const void* ws, const void* vq,
                               const void* vs, const void* bias, const void* res, void* out,
                               int M, int N, int K, int tiles_per_block, float eps,
                               void* stream) {
  const bool has_ln = ln_w != nullptr && ln_b != nullptr;
  if (M <= 0 || K <= 0 || K % kKC || K > kMaxK || tiles_per_block <= 0 ||
      (mode == 0 && N % kBN) || (mode == 1 && (N % (kBN / 2) || !has_ln || !vq || !vs)) ||
      (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  Args p{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_w),
         static_cast<const float*>(ln_b), static_cast<const int8_t*>(wq),
         static_cast<const float*>(ws), static_cast<const int8_t*>(vq),
         static_cast<const float*>(vs), static_cast<const float*>(bias),
         static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
         M, N, K, tiles_per_block, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return (int)launch<true, 1>(p, st);
  return (int)(has_ln ? launch<true, 0>(p, st) : launch<false, 0>(p, st));
}
