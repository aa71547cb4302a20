// W8A8 GEMMs of the NAR decoder layer for Hopper (sm_90a): K3 fused_linear
// and K4 fused_ffn.
//
// Replaces the TPU kernels mars5_tts_tpu/ops/pallas/nar_fused.py::_lin_kernel
// (entry fused_linear) and ::_ffn_kernel (entry fused_ffn), groups = 1.
//
// One entry, mars5_w8a8_gemm, over the GEMM tile of w8a8_gemm.cuh, in two modes:
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
// squared deviations, (x - mean) / sqrt(var + eps), * w + b), rounded to
// bf16 and back, the two means summed in f64 and rounded once; xs = max(amax, 1e-8) / 127 and q = rint(x / xs) clipped to
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

#include "w8a8_gemm.cuh"

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
         M, N, K, tiles_per_block, eps, nullptr, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return (int)launch<true, 1>(p, st);
  return (int)(has_ln ? launch<true, 0>(p, st) : launch<false, 0>(p, st));
}
