// Device helpers shared by the quantized AR decode kernels (decode_layer.cu,
// head4.cu): per-row int8 quantization, nibble unpacking and the warp-per-row
// int8 GEMV inner loop.
//
// A GEMV here multiplies one int8 activation row, kept in shared memory, by
// a weight matrix whose rows stream from device memory exactly once. One warp
// owns one output row: each lane holds up to kMaxChunks 16-byte chunks of the
// row in registers (issued before the block's prologue, so the loads fly
// while the activation is being quantized) and multiplies them with __dp4a
// (4 x int8 -> int32). Integer sums are exact, so the lane and warp order
// does not matter.
//
// int4 rows (W4) pack two values a byte: the low nibble is input column c of
// the left half, the high nibble column c + K/2 of the right half, both
// sign-extended. The two halves sum into separate accumulators (ya, yb) so a
// caller can scale them apart.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace mars5 {

constexpr int kMaxChunks = 8;  // 16-byte chunks of one weight row a lane holds (<= 4096 B a row)

// Round half to even of a true division, clipped to +-127 (jnp.round / torch.round).
__device__ __forceinline__ int quant127(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return max(-127, min(127, q));
}

// The row scale of a quantized row: max(amax, 1e-8) / 127.
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
}

// Sign-extended low / high nibbles of four packed bytes, byte for byte.
__device__ __forceinline__ int lo_nibbles(uint32_t w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int hi_nibbles(uint32_t w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// Block-wide reductions for a block of kWarps warps; every thread gets the
// result. The order is fixed by the block size, so every block of a launch
// computes bit-identical values from the same data. `red` holds kWarps floats.
template <int kWarps>
__device__ __forceinline__ float block_max(float v, float* red) {
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
// Sums are accumulated in f64 and rounded to f32 once, which gives the same
// f32 value in any order (the plain twins sum in f64 too). `red` holds kWarps doubles.
template <int kWarps>
__device__ __forceinline__ float block_sum(double v, double* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r += red[i];
  return (float)r;
}

// One weight row in a warp's registers.
struct RowRegs {
  uint4 c[kMaxChunks];
};

// Issue the loads of a row of n_chunks 16-byte chunks (streamed: evict first).
__device__ __forceinline__ void load_row(RowRegs& r, const int8_t* row, int n_chunks, int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int idx = lane + 32 * i;
    if (idx < n_chunks) r.c[i] = __ldcs(src + idx);
  }
}

__device__ __forceinline__ int dp4a4(uint4 w, uint4 x, int acc) {
  acc = __dp4a((int)w.x, (int)x.x, acc);
  acc = __dp4a((int)w.y, (int)x.y, acc);
  acc = __dp4a((int)w.z, (int)x.z, acc);
  return __dp4a((int)w.w, (int)x.w, acc);
}

// int8 row . x8 (shared, 16-byte aligned): this lane's partial sum.
__device__ __forceinline__ int dot_s8(const RowRegs& r, const int8_t* x8, int n_chunks, int lane) {
  const uint4* xv = reinterpret_cast<const uint4*>(x8);
  int acc = 0;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int idx = lane + 32 * i;
    if (idx < n_chunks) acc = dp4a4(r.c[i], xv[idx], acc);
  }
  return acc;
}

// Packed int4 row . x8: partial sums over the left half (low nibbles, ya)
// and the right half (high nibbles, yb); half = K / 2 bytes of x8.
__device__ __forceinline__ void dot_s4(const RowRegs& r, const int8_t* x8, int half,
                                       int n_chunks, int lane, int& ya, int& yb) {
  const uint4* xl = reinterpret_cast<const uint4*>(x8);
  const uint4* xh = reinterpret_cast<const uint4*>(x8 + half);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int idx = lane + 32 * i;
    if (idx < n_chunks) {
      const uint4 w = r.c[i];
      const uint4 lo = make_uint4(lo_nibbles(w.x), lo_nibbles(w.y), lo_nibbles(w.z), lo_nibbles(w.w));
      const uint4 hi = make_uint4(hi_nibbles(w.x), hi_nibbles(w.y), hi_nibbles(w.z), hi_nibbles(w.w));
      ya = dp4a4(lo, xl[idx], ya);
      yb = dp4a4(hi, xh[idx], yb);
    }
  }
}

__device__ __forceinline__ int warp_isum(int v) { return __reduce_add_sync(0xffffffffu, v); }

}  // namespace mars5
