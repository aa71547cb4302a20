// W4A8 output head of the quantized AR decode engine for Hopper (sm_90a):
// kernel K8 head4_logits.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/head4.py::_head4_kernel
// (entry head4_logits): logits = x8 . unpack(wp)^T with nibble-packed int4
// weights (low nibble: input column c of the left half, high nibble: column
// c + K/2), one scale per output row and half, the B <= 8 int8 activation
// rows and their scales quantized by the caller. y = (yl * ws0 + yh * ws1) * xs.
//
// What bounds it: the weight stream, V x K/2 bytes (18.4 MB at 24,000 x 1536)
// for any number of activation rows. One warp per vocabulary row streams its
// packed row once with 16-byte loads, keeps it in registers and dots it with
// every activation row with __dp4a; a block of 8 warps shares the activation
// rows in shared memory. The TPU kernel's 2048-row blocks and vocabulary
// padding are not needed: the grid covers V and the last block masks its
// rows.
//
// The C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_s8.cuh"

namespace {

using namespace mars5;

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;
constexpr int kMaxBatch = 8;

__global__ void __launch_bounds__(kThreads)
head4_kernel(const int8_t* x8, const float* xs, const int8_t* wp, const float* ws, float* out,
             int B, int V, int K, int ws_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xsh = reinterpret_cast<int8_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  const int half = K / 2, n_chunks = half / 16;
  RowRegs r;
  if (row < V) load_row(r, wp + (long long)row * half, n_chunks, lane);
  for (int i = threadIdx.x; i < B * K / 16; i += kThreads)
    reinterpret_cast<uint4*>(xsh)[i] = reinterpret_cast<const uint4*>(x8)[i];
  __syncthreads();
  if (row >= V) return;
  for (int b = 0; b < B; ++b) {
    int yl = 0, yh = 0;
    dot_s4(r, xsh + (long long)b * K, half, n_chunks, lane, yl, yh);
    yl = warp_isum(yl);
    yh = warp_isum(yh);
    if (lane == 0)
      out[(long long)b * V + row] = __fmul_rn(__fadd_rn(__fmul_rn((float)yl, ws[row]),
                                                        __fmul_rn((float)yh, ws[ws_stride + row])),
                                              xs[b]);
  }
}

}  // namespace

// x8 (B, K) int8 and xs (B) f32: the quantized activation rows, 1 <= B <= 8;
// wp (V, K/2) packed int4; ws (2, ws_stride) f32 with ws_stride >= V; out
// (B, V) f32.
extern "C" int mars5_head4_logits(const void* x8, const void* xs, const void* wp,
                                  const void* ws, void* out, int B, int V, int K, int ws_stride,
                                  void* stream) {
  if (B < 1 || B > kMaxBatch || V <= 0 || K <= 0 || K % 32 ||
      K / 2 > 16 * 32 * kMaxChunks || ws_stride < V || B * K > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  head4_kernel<<<(V + kRows - 1) / kRows, kThreads, (size_t)B * K,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wp), static_cast<const float*>(ws), static_cast<float*>(out),
      B, V, K, ws_stride);
  return (int)cudaGetLastError();
}
