// W4A8 output head of the quantized AR decode engine for Hopper (sm_90a):
// kernel K8 head4_logits.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/head4.py::_head4_kernel
// (entry head4_logits, with the activation quant its jitted wrapper does):
// logits = q(x) . unpack(wp)^T with nibble-packed int4 weights (low nibble:
// input column c of the left half, high nibble: column c + K/2), one scale
// per output row and half, and the B <= 8 activation rows quantized to int8
// per row (xs = max(amax, 1e-8) / 127, rint(x / xs) clipped to +-127, by
// true division). y = (yl * ws0 + yh * ws1) * xs.
//
// What bounds it: the weight stream, V x K/2 bytes (18.4 MB at 24,000 x
// 1536, 5.5 us at 3.35 TB/s) for any number of activation rows. What the
// design does about it:
// - One launch a call, a grid sized to the SMs: block i owns the contiguous
//   slab of rows_per_block vocabulary rows from i x rows_per_block (the host
//   plan, ops/kernels/head4.py slab_plan; the last slab is ragged).
// - Thread 0 streams the slab with 1-D bulk asynchronous copies
//   (cp.async.bulk, mbarrier completion) of kStageRows packed rows into a ring
//   of `stages` shared-memory stages, each with a full and an empty mbarrier.
//   The first `stages` copies are issued before anything else, so the pack's
//   bytes are in flight while the block quantizes its activation rows; a stage
//   is refilled as soon as its eight warps have handed it back.
// - The activation quant runs in every block, all its threads over the
//   B <= 8 rows, reading the bf16 or f32 rows twice from L2 (amax, then the
//   int8 rows into shared memory). The wrapper runs no op before the launch.
// - A warp takes kRowsPerWarp rows of a stage and dots them with every
//   activation row at once (each int8 activation load from shared memory
//   serves four weight rows), __dp4a on the sign-extended nibbles, int32
//   sums (exact in any order), one redux a sum; lane b x 4 + r writes the
//   logit of activation row b and packed row r. The warp hands the stage
//   back when its rows are done; thread 0 refills it once all eight have.
//
// The C entry returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_s8.cuh"
#include "hopper.cuh"

namespace {

using namespace mars5;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kStageRows = kWarps * kRowsPerWarp;   // packed rows a ring stage
constexpr int kMaxBatch = 8;                        // activation rows (x kRowsPerWarp = 32 lanes)
constexpr int kMaxRowBytes = 4096;                  // a packed row (K / 2)

struct Head4Args {
  const void* x;           // (B, K) bf16 or f32, contiguous, 16-byte aligned
  const int8_t* wp;        // (V, K/2) packed int4, 16-byte aligned
  const float* ws;         // (2, ws_stride) f32
  float* out;              // (B, V) f32
  int B, V, K, ws_stride, rows_per_block, stages;
};

// The eight values of x at [i, i + 8) as floats (bf16 and f32 convert exactly).
template <typename T>
__device__ __forceinline__ void load8(const T* x, int i, float* v) {
  if constexpr (sizeof(T) == 2) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(x + i));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + i + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

// The B rows of x (B, K), contiguous, to per-row int8 in x8 (B, K) and their
// scales in xs[B], by the whole block: each thread takes 8-value chunks, the
// row's amax gathered by a shared-memory atomicMax on the float's bits (the
// values are >= 0, so the bits order as the floats do); amax holds B zeros
// on entry. Each pass reads x from L2; the second writes the int8 rows.
template <typename T>
__device__ __forceinline__ void quantize_rows(const T* x, int B, int K, int8_t* x8, float* xs,
                                              int* amax) {
  const int n8 = K / 8, items = B * n8;
  float v[8];
  for (int i = threadIdx.x; i < items; i += kThreads) {
    load8(x, 8 * i, v);
    float am = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) am = fmaxf(am, fabsf(v[j]));
    atomicMax(amax + i / n8, __float_as_int(am));
  }
  __syncthreads();
  if (threadIdx.x < B) xs[threadIdx.x] = row_scale(__int_as_float(amax[threadIdx.x]));
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += kThreads) {
    load8(x, 8 * i, v);
    const float s = xs[i / n8];
    uint32_t p[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[j >> 2] |= (uint32_t)(uint8_t)(int8_t)quant127(v[j], s) << (8 * (j & 3));
    *reinterpret_cast<uint2*>(x8 + 8 * i) = make_uint2(p[0], p[1]);
  }
}

__device__ __forceinline__ int dp4a2(uint2 w, uint2 x, int acc) {
  return __dp4a((int)w.y, (int)x.y, __dp4a((int)w.x, (int)x.x, acc));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) head4_kernel(Head4Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int half = a.K / 2, n8 = half / 8;          // 8-byte chunks of a packed row
  const int stage_bytes = kStageRows * half;
  int8_t* x8 = reinterpret_cast<int8_t*>(smem + a.stages * stage_bytes);
  float* xs = reinterpret_cast<float*>(x8 + a.B * a.K);
  int* amax = reinterpret_cast<int*>(xs + kMaxBatch);
  const uint32_t full = smem_addr(amax + kMaxBatch), empty = full + 8 * a.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.V, r0 + a.rows_per_block);
  const int n_chunks = (r1 - r0 + kStageRows - 1) / kStageRows;

  // thread 0: chunk c of the slab into stage c % stages
  auto issue = [&](int c) {
    const int s = c % a.stages, row = r0 + c * kStageRows;
    const uint32_t bytes = (uint32_t)(min(kStageRows, r1 - row) * half);
    mbar_arrive_expect_tx(full + 8 * s, bytes);
    bulk_load(smem_addr(smem + s * stage_bytes), a.wp + (long long)row * half, bytes,
              full + 8 * s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps);
    }
    mbar_init_fence();
    for (int c = 0; c < min(a.stages, n_chunks); ++c) issue(c);
  }
  if (threadIdx.x < a.B) amax[threadIdx.x] = 0;
  __syncthreads();
  quantize_rows(static_cast<const T*>(a.x), a.B, a.K, x8, xs, amax);
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % a.stages, parity = (c / a.stages) & 1;
    const int row0 = r0 + c * kStageRows + warp * kRowsPerWarp;
    const int nr = min(kRowsPerWarp, r1 - row0);     // this warp's rows in the chunk (may be <= 0)
    mbar_wait(full + 8 * s, parity);
    if (nr > 0) {
      const uint2* st = reinterpret_cast<const uint2*>(smem + s * stage_bytes +
                                                       warp * kRowsPerWarp * half);
      int yl[kMaxBatch][kRowsPerWarp], yh[kMaxBatch][kRowsPerWarp];
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b)
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) yl[b][r] = yh[b][r] = 0;
      for (int j = lane; j < n8; j += 32) {
        // this lane's 8-byte chunk of each row, as sign-extended nibbles: lo
        // (columns 8 j .. 8 j + 7 of the left half of K) and hi (the right half)
        uint2 lo[kRowsPerWarp], hi[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const uint2 w = r < nr ? st[r * n8 + j] : make_uint2(0u, 0u);
          lo[r] = make_uint2(lo_nibbles(w.x), lo_nibbles(w.y));
          hi[r] = make_uint2(hi_nibbles(w.x), hi_nibbles(w.y));
        }
#pragma unroll
        for (int b = 0; b < kMaxBatch; ++b) {
          if (b >= a.B) break;
          const uint2 al = reinterpret_cast<const uint2*>(x8 + b * a.K)[j];
          const uint2 ah = reinterpret_cast<const uint2*>(x8 + b * a.K + half)[j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            yl[b][r] = dp4a2(lo[r], al, yl[b][r]);
            yh[b][r] = dp4a2(hi[r], ah, yh[b][r]);
          }
        }
      }
      // lane b x kRowsPerWarp + r keeps the sums of activation row b and
      // packed row r, and writes that logit
      int ml = 0, mh = 0;
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b >= a.B) break;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int sl = warp_isum(yl[b][r]), sh = warp_isum(yh[b][r]);
          if (lane == b * kRowsPerWarp + r) ml = sl, mh = sh;
        }
      }
      const int b = lane / kRowsPerWarp, r = lane % kRowsPerWarp;
      if (b < a.B && r < nr) {
        const int row = row0 + r;
        a.out[(long long)b * a.V + row] =
            __fmul_rn(__fadd_rn(__fmul_rn((float)ml, __ldg(a.ws + row)),
                                __fmul_rn((float)mh, __ldg(a.ws + a.ws_stride + row))),
                      xs[b]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with the stage
    if (threadIdx.x == 0 && c + a.stages < n_chunks) {
      mbar_wait(empty + 8 * s, parity);
      issue(c + a.stages);
    }
  }
}

long long kernel_launches = 0;          // kernels this library has launched

}  // namespace

// x (B, K) bf16 (is_f32 = 0) or f32, 1 <= B <= 8, contiguous and 16-byte
// aligned; wp (V, K/2) packed int4, 16-byte aligned; ws (2, ws_stride) f32
// with ws_stride >= V; out (B, V) f32. rows_per_block, grid, stages and smem:
// the host plan (ops/kernels/head4.py slab_plan).
extern "C" int mars5_head4_logits(const void* x, int is_f32, const void* wp, const void* ws,
                                  void* out, int B, int V, int K, int ws_stride,
                                  int rows_per_block, int grid, int stages, int smem,
                                  void* stream) {
  if (B < 1 || B > kMaxBatch || V <= 0 || K <= 0 || K % 32 || K / 2 > kMaxRowBytes ||
      ws_stride < V || rows_per_block <= 0 || grid <= 0 ||
      (long long)rows_per_block * grid < V || (long long)rows_per_block * (grid - 1) >= V ||
      stages < 1 || smem < stages * kStageRows * (K / 2) + B * K + 8 * kMaxBatch + 16 * stages ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  static int configured[2] = {0, 0};            // the largest smem allowed so far, per input type
  const auto kernel = is_f32 ? head4_kernel<float> : head4_kernel<__nv_bfloat16>;
  if (smem > configured[is_f32 != 0]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured[is_f32 != 0] = smem;
  }
  const Head4Args a{x, static_cast<const int8_t*>(wp), static_cast<const float*>(ws),
                    static_cast<float*>(out), B, V, K, ws_stride, rows_per_block, stages};
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  ++kernel_launches;
  return (int)cudaGetLastError();
}

// Kernels launched by this library so far (one a call).
extern "C" long long mars5_head4_kernel_launches() { return kernel_launches; }
