// W8A8 GEMMs of the NAR decoder layer for Hopper (sm_90a): K3 fused_linear
// and K4 fused_ffn.
//
// Replaces the TPU kernels mars5_tts_tpu/ops/pallas/nar_fused.py::_lin_kernel
// (entry fused_linear) and ::_ffn_kernel (entry fused_ffn), groups = 1 and,
// with gsize < K, per-K-group scales (_qdot with groups > 1: w8a8_wgmma.cuh's
// grouped prologue and GEMM, 64- or 128-wide tiles).
//
//   K3 (mars5_w8a8_linear): prologue([LN](x)) -> q, xs; then
//     out = bf16(rescale(q . W^T) [+ bias]) [+ residual]          (2 launches)
//   K4 (mars5_w8a8_ffn): prologue(LN(x)) -> q, xs;
//     u = bf16(bf16(silu(wo)) * vo), wo/vo = bf16(rescale(q . W^T / V^T));
//     prologue(u) -> q, xs; out = bf16(rescale(q . lin2^T) + b) + x (4 launches)
//
//   x (M, K) bf16 row-major; W/V (N, K) int8 row-major with f32 per-row
//   scales; the LN vectors (K,) and the bias (N,) bf16 or f32 (vec_bf16),
//   read as they are; residual (M, N) bf16 row-major; out (M, N) bf16
//   row-major. The kernels and their numerics are in w8a8_wgmma.cuh.
//
// What bounds it on an H100: at the decoder's M = 2 x 1200 rows the qkv GEMM
// is 7.5 G int8 MACs (7.6 us at the int8 peak) over 3 MB of weights; K4 is
// 3 x 7.5 G MACs (22.9 us). The tensor cores bound both; only wgmma reaches
// their rate, and at 128 x 128 tiles each 128-deep slice (32 KB from L2)
// feeds 2 M MACs, so L2 bandwidth is the next limit. The TPU kernels kept a
// row block and its whole (rows x 2F) intermediate in VMEM; a Hopper CTA
// cannot hold 128 rows of u (768 KB bf16), so the re-quant of u (its row
// amax over all F columns) is the second prologue, reading u from device
// scratch (15 MB at the bench shape, served from the 50 MB L2). The
// prologue runs once a row: LN and quantisation are no longer redone by each
// CTA that shares a row block. One persistent CTA a SM walks the tiles.
// Tiles are 128 rows x 256 weight rows where that still gives every SM a
// tile (qkv: 19 x 12 = 228 tiles at M = 2400; K4's W and V GEMM 19 x 24,
// 128 u columns each), else 128 x 128 (caq and lin2: 19 x 8 = 152, 1.15 a
// SM: the wave quantisation is kept, a narrower tile would halve each
// slice's reuse); ops/kernels/nar_fused.py gemm_plan decides. A grouped
// GEMM takes 128- or 64-wide tiles by the wave tail, a tile's time taken as
// the A and weight rows its stages pull (the decoder's sites: 128-wide, e.g.
// qkv 456 tiles in 4 rounds against 912 of 64 in 7).
//
// The C entry points encode the tensor maps (cuTensorMapEncodeTiled through
// the runtime), launch, and return cudaGetLastError() after each launch, or
// cudaErrorInvalidValue for arguments the kernels do not take. The caller
// gives the grid and the tile's weight rows (ops/kernels/nar_fused.py
// gemm_plan; the tiles and TMA boxes follow from them here and in
// w8a8_wgmma.cuh) and the scratch: q (M x max(K, F) int8), then xs (M f32;
// grouped G x xs_pitch f32, G the larger group count, xs_pitch the caller's:
// nar_fused.py xs_pitch).

#include "w8a8_wgmma.cuh"

namespace {

bool bad_shape(int M, int N, int K, int grid, int bn) {
  return M <= 0 || N <= 0 || N % 64 || K <= 0 || K % kBK || K > kMaxK || grid <= 0 ||
         (bn != 64 && bn != 128 && bn != 256);
}

// A group size the grouped kernels take over K (gsize == K: one group, the
// ungrouped kernels, 128- or 256-wide tiles): a multiple of 32 (one s8 wgmma
// step) dividing K, and 64- or 128-wide tiles.
bool bad_groups(int K, int gsize, int bn) {
  return gsize <= 0 || gsize % 32 || K % gsize || (gsize != K ? bn == 256 : bn == 64);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// The grouped scales' row pitch: whole 16-byte rows that hold M floats.
bool bad_pitch(int M, int xs_pitch) { return xs_pitch < M || xs_pitch % 4; }

// The per-row prologue, or the grouped one when gsize < K.
cudaError_t prologue(const __nv_bfloat16* x, const void* ln_w, const void* ln_b, int vec_bf16,
                     float eps, int8_t* q, float* xs, int M, int K, int gsize, int xs_pitch,
                     cudaStream_t st) {
  if (gsize == K) return launch_prologue(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, st);
  return launch_prologue_grouped(x, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, gsize, xs_pitch, st);
}

cudaError_t gemm0(int bn, bool bf16_bias, int gsize, bool w_grouped, int grid, cudaStream_t st,
                  const CUtensorMap& ta, const CUtensorMap& tw, const Epilogue& p) {
  if (gsize == p.K) return launch_gemm0(bn, bf16_bias, grid, st, ta, tw, p);
  if (bn == 64)
    return w_grouped ? launch_gemm0_grouped<64, 1>(bf16_bias, grid, st, ta, tw, p)
                     : launch_gemm0_grouped<64, 2>(bf16_bias, grid, st, ta, tw, p);
  return w_grouped ? launch_gemm0_grouped<128, 1>(bf16_bias, grid, st, ta, tw, p)
                   : launch_gemm0_grouped<128, 2>(bf16_bias, grid, st, ta, tw, p);
}

cudaError_t swiglu(int bn, int gsize, bool w_grouped, int grid, cudaStream_t st,
                   const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& tv,
                   const Epilogue& p) {
  if (gsize == p.K) return launch_swiglu(bn, grid, st, ta, tw, tv, p);
  if (bn == 64)
    return w_grouped ? launch_swiglu_grouped<64, 1>(grid, st, ta, tw, tv, p)
                     : launch_swiglu_grouped<64, 2>(grid, st, ta, tw, tv, p);
  return w_grouped ? launch_swiglu_grouped<128, 1>(grid, st, ta, tw, tv, p)
                   : launch_swiglu_grouped<128, 2>(grid, st, ta, tw, tv, p);
}

}  // namespace

// gsize: K columns a group of activation (and, with w_grouped, weight)
// scales, K for one scale a row; ws (G, N) when w_grouped (16-byte aligned:
// the GEMM copies its rows in bulk), else (N,); xs_pitch: the row pitch of
// the grouped activation scales (G, xs_pitch) in the scratch, a multiple of 4
// floats >= M (read only when grouped).
extern "C" int mars5_w8a8_linear(const void* x, const void* ln_w, const void* ln_b,
                                 const void* bias, int vec_bf16, float eps, const void* wq,
                                 const void* ws, const void* res, void* out, void* scratch, int M,
                                 int N, int K, int grid, int bn, int gsize, int w_grouped,
                                 int xs_pitch, void* stream) {
  if (bad_shape(M, N, K, grid, bn) || bad_groups(K, gsize, bn) || (w_grouped && gsize == K) ||
      (gsize != K && bad_pitch(M, xs_pitch)) ||
      misaligned(x) || misaligned(res) || misaligned(ln_w) || misaligned(ln_b) ||
      misaligned(bias) || (w_grouped && misaligned(ws)) || (ln_w == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  int8_t* q = static_cast<int8_t*>(scratch);
  float* xs = reinterpret_cast<float*>(q + (long long)M * K);   // grouped: (G, xs_pitch)
  CUtensorMap ta, tw;
  if (!encode_map_s8(&ta, q, M, K, kBM) || !encode_map_s8(&tw, wq, N, K, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prologue(xb, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, gsize, xs_pitch, st);
  if (err != cudaSuccess) return (int)err;
  const Epilogue p{xs, static_cast<const float*>(ws), nullptr, bias,
                   static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
                   M, N, K, gsize, xs_pitch};
  return (int)gemm0(bn, vec_bf16 != 0, gsize, w_grouped != 0, grid, st, ta, tw, p);
}

// gsize1 / w1_grouped for the W and V GEMM (over K), gsize2 / w2_grouped
// for lin2 (over F), as in mars5_w8a8_linear.
extern "C" int mars5_w8a8_ffn(const void* x, const void* ln_w, const void* ln_b,
                              const void* l2b, int vec_bf16, float eps, const void* wq,
                              const void* ws, const void* vq, const void* vs, const void* l2q,
                              const void* l2s, void* u, void* out, void* scratch, int M, int K,
                              int F, int grid1, int bn1, int grid2, int bn2, int gsize1,
                              int w1_grouped, int gsize2, int w2_grouped, int xs_pitch,
                              void* stream) {
  if (bad_shape(M, F, K, grid1, bn1) || F % (bn1 / 2) || bad_shape(M, K, F, grid2, bn2) ||
      bad_groups(K, gsize1, bn1) || bad_groups(F, gsize2, bn2) || (w1_grouped && gsize1 == K) ||
      (w2_grouped && gsize2 == F) || ((gsize1 != K || gsize2 != F) && bad_pitch(M, xs_pitch)) ||
      misaligned(x) || ln_w == nullptr || ln_b == nullptr ||
      l2b == nullptr || misaligned(ln_w) || misaligned(ln_b) || misaligned(l2b) ||
      (w1_grouped && (misaligned(ws) || misaligned(vs))) || (w2_grouped && misaligned(l2s)))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  int8_t* q = static_cast<int8_t*>(scratch);
  float* xs = reinterpret_cast<float*>(q + (long long)M * (K > F ? K : F));
  CUtensorMap ta1, tw, tv, ta2, tl;
  if (!encode_map_s8(&ta1, q, M, K, kBM) || !encode_map_s8(&tw, wq, F, K, bn1 / 2) ||
      !encode_map_s8(&tv, vq, F, K, bn1 / 2) || !encode_map_s8(&ta2, q, M, F, kBM) ||
      !encode_map_s8(&tl, l2q, K, F, bn2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ub = static_cast<__nv_bfloat16*>(u);

  cudaError_t err = prologue(xb, ln_w, ln_b, vec_bf16, eps, q, xs, M, K, gsize1, xs_pitch, st);
  if (err != cudaSuccess) return (int)err;
  const Epilogue p1{xs, static_cast<const float*>(ws), static_cast<const float*>(vs), nullptr,
                    nullptr, ub, M, F, K, gsize1, xs_pitch};
  err = swiglu(bn1, gsize1, w1_grouped != 0, grid1, st, ta1, tw, tv, p1);
  if (err != cudaSuccess) return (int)err;

  // u's rows quantised over all F columns (or per group) into the same scratch
  err = prologue(ub, nullptr, nullptr, vec_bf16, eps, q, xs, M, F, gsize2, xs_pitch, st);
  if (err != cudaSuccess) return (int)err;
  const Epilogue p2{xs, static_cast<const float*>(l2s), nullptr, l2b, xb,
                    static_cast<__nv_bfloat16*>(out), M, K, F, gsize2, xs_pitch};
  return (int)gemm0(bn2, vec_bf16 != 0, gsize2, w2_grouped != 0, grid2, st, ta2, tl, p2);
}
