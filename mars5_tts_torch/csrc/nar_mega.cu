// The whole W8A8 NAR decoder stack for Hopper (sm_90a): K9 mega_decoder_stack.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/nar_mega.py::_make_kernel
// (entry mega_decoder_stack), which ran every decoder layer as one Pallas
// program with the (B, L, D) stream resident in VMEM. Per layer, the x
// stream in bf16 throughout:
//
//   s0   qkv  = bf16(W8A8(LN1(x)) + b)                       (M, 3D)
//   SA   a    = attention(q, k, v; key-padding mask)           (M, D)
//   s1   x   += bf16(W8A8(a) + b)                              sa_out
//   s2   hq   = bf16(W8A8(LN2(x)) + b)                         ca_q
//   s3   ckv  = bf16(W8A8(mem8) + b)                           ca_kv (B Lk, 2D)
//   CA   a    = attention(hq, ck, cv; memory mask)
//   s4   x   += bf16(W8A8(a) + b)                              ca_out
//   WV   u    = bf16(bf16(silu(w)) * v), w, v = bf16(W8A8(LN3(x)))   (M, F)
//   lin2 x   += bf16(W8A8(u) + b)
//
// with the memory quantized to int8 once per call (mem8), not once a layer.
//
//   x (B L, D) bf16, updated in place; mem (B Lk, D) bf16; masks (B, L) and
//   (B, Lk) uint8, nonzero = ignore, or null; pack (n_layers, 8 D^2 + 3 F D)
//   int8, each layer's stages row-major at their offsets [qkv (3D, D) |
//   sa_out (D, D) | ca_q (D, D) | ca_kv (2D, D) | ca_out (D, D) | WV (2F, D),
//   W rows then V rows | lin2 (D, F)]; svec (n_layers, 9D + 2F), bvec
//   (n_layers, 9D), lnvec (n_layers, 6D) f32 (ops/kernels/nar_mega.py
//   build_mega_pack). Scratch from the caller: qkv (B L, 3D), attn and hq
//   (B L, D), ckv (B Lk, 2D), u (B L, F) bf16; mem8 (B Lk, D) int8, ms (B Lk)
//   f32.
//
// Numerics: the GEMM sites are those of K3/K4 (w8a8_gemm.cuh). Both attentions are full-row
// softmax, s = q.k in f32 (bf16 mma), p = exp2((s - max s) * scale*log2e),
// the row sum of p in f64 rounded once, p rounded to bf16 before PV (f32
// accumulation), o / sum last: the twin's mega_decoder_stack_ref.
//
// What bounds it here: at the bench geometry (2 x 1200 rows, D 1024, F 3072,
// 16 layers) one call is 1.21 T int8 ops of GEMM (0.61 ms at 1,979 TOP/s),
// 0.19 TFLOP of bf16 attention and 285 MB of weights (85 us at 3.35 TB/s):
// the tensor cores bound it. The TPU program held the stream in VMEM across
// layers; this first version is one C entry issuing 1 + 9 launches a layer
// with no host work between them, and keeps the activations (44 MB at the
// bench geometry) in device scratch, most of which the 50 MB L2 serves. The
// attention gives a block 64 queries of one head and walks the keys twice
// in 64-wide shared-memory tiles: the first pass takes each row's max, the
// second forms p, its f64 sum and PV, so the softmax needs no running
// rescale and matches the full-row form. No cooperative persistent launch,
// wgmma or TMA yet.
//
// The C entry point returns the first launch error (cudaGetLastError()).

#include "w8a8_gemm.cuh"

namespace {

constexpr int kHD = 64;          // head dim
constexpr int kQB = 64;          // queries per attention block (16 per warp)
constexpr int kKB = 64;          // keys per shared-memory tile
constexpr int kLd = kHD + 8;     // padded smem row (bf16): conflict-free fragment reads
constexpr int kAThreads = 128;

struct AttnArgs {
  const __nv_bfloat16* q;        // row r of batch b at q + (b Lq + r) q_row + h 64
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long q_row, kv_row;       // row strides in elements
  const uint8_t* mask;           // (B, Lk), nonzero = ignore, or null
  __nv_bfloat16* out;            // (B Lq, H 64)
  int Lq, Lk, H;
  float c2;                      // scale * log2(e)
};

// Stage 64 keys (and, with kV, the values transposed) into shared memory;
// rows past Lk are zero.
template <bool kV>
__device__ __forceinline__ void stage_kv(const AttnArgs& p, const __nv_bfloat16* kb,
                                         const __nv_bfloat16* vb, int k0,
                                         __nv_bfloat16 (*Ks)[kLd], __nv_bfloat16 (*Vt)[kLd]) {
  for (int c = threadIdx.x; c < kKB * (kHD / 8); c += kAThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
    if (k0 + r < p.Lk) {
      kv = *reinterpret_cast<const int4*>(kb + (long long)(k0 + r) * p.kv_row + col);
      if (kV) vv = *reinterpret_cast<const int4*>(vb + (long long)(k0 + r) * p.kv_row + col);
    }
    *reinterpret_cast<int4*>(&Ks[r][col]) = kv;
    if (kV) {
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[col + j][r] = ve[j];
    }
  }
}

// Scores of this warp's 16 query rows against the staged 64 keys, -inf on
// masked and ragged keys. Fragment layouts follow the PTX m16n8k16 tables:
// lane = 4g + t holds C rows {g, g+8} x cols {2t, 2t+1} of each n-tile.
__device__ __forceinline__ void tile_scores(float (*s)[4], const uint32_t (*qf)[4],
                                            const __nv_bfloat16 (*Ks)[kLd], const uint8_t* mb,
                                            int k0, int Lk, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kKB / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHD / 16; ++ks) {
      const int n = nt * 8 + g, kk = ks * 16 + 2 * t;
      const uint32_t bf[2] = {ld32(&Ks[n][kk]), ld32(&Ks[n][kk + 8])};
      mma_bf16_16816(s[nt], qf[ks], bf);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + nt * 8 + 2 * t + (i & 1);
      if (key >= Lk || (mb != nullptr && mb[key])) s[nt][i] = -INFINITY;
    }
  }
}

// One block = (64 query rows, one head, one batch row); 4 warps, 16 rows each.
__global__ void __launch_bounds__(kAThreads) attn_kernel(AttnArgs p) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kQB][kLd];
  __shared__ __align__(16) __nv_bfloat16 Ks[kKB][kLd];
  __shared__ __align__(16) __nv_bfloat16 Vt[kHD][kLd];  // V transposed: [d][key]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kQB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = p.q + (long long)b * p.Lq * p.q_row + h * kHD;
  const __nv_bfloat16* kb = p.k + (long long)b * p.Lk * p.kv_row + h * kHD;
  const __nv_bfloat16* vb = p.v + (long long)b * p.Lk * p.kv_row + h * kHD;
  const uint8_t* mb = p.mask ? p.mask + (long long)b * p.Lk : nullptr;

  for (int c = tid; c < kQB * (kHD / 8); c += kAThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + r < p.Lq) val = *reinterpret_cast<const int4*>(qb + (long long)(q0 + r) * p.q_row + col);
    *reinterpret_cast<int4*>(&Qs[r][col]) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[kHD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kHD / 16; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    qf[ks][0] = ld32(&Qs[r0][c0]);
    qf[ks][1] = ld32(&Qs[r0 + 8][c0]);
    qf[ks][2] = ld32(&Qs[r0][c0 + 8]);
    qf[ks][3] = ld32(&Qs[r0 + 8][c0 + 8]);
  }

  // pass 1: each row's max over all keys
  float s[kKB / 8][4];
  float mx[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < p.Lk; k0 += kKB) {
    __syncthreads();
    stage_kv<false>(p, kb, vb, k0, Ks, Vt);
    __syncthreads();
    tile_scores(s, qf, Ks, mb, k0, p.Lk, g, t);
#pragma unroll
    for (int nt = 0; nt < kKB / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // pass 2: p, its f64 row sum, and P V
  float o[kHD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  double rs[2] = {0.0, 0.0};
  for (int k0 = 0; k0 < p.Lk; k0 += kKB) {
    __syncthreads();
    stage_kv<true>(p, kb, vb, k0, Ks, Vt);
    __syncthreads();
    tile_scores(s, qf, Ks, mb, k0, p.Lk, g, t);
#pragma unroll
    for (int nt = 0; nt < kKB / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = exp2f(__fmul_rn(__fsub_rn(s[nt][i], mx[i >> 1]), p.c2));
        s[nt][i] = pv;
        rs[i >> 1] += (double)pv;
      }
    // the S accumulators of n-tiles (2kc, 2kc+1) are the A fragment of key chunk kc
#pragma unroll
    for (int kc = 0; kc < kKB / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kHD / 8; ++dt) {
        const int n = dt * 8 + g, kk = kc * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(&Vt[n][kk]), ld32(&Vt[n][kk + 8])};
        mma_bf16_16816(o[dt], pa, bf);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.Lq) continue;
    const float sum = (float)rs[r];
    __nv_bfloat16* orow = p.out + ((long long)b * p.Lq + row) * p.H * kHD + h * kHD;
#pragma unroll
    for (int dt = 0; dt < kHD / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16(__fdiv_rn(o[dt][2 * r], sum), __fdiv_rn(o[dt][2 * r + 1], sum));
    }
  }
}

// One warp quantises one memory row (per-row int8, the GEMMs' act quant).
__global__ void __launch_bounds__(128) quant_rows_kernel(Args p, int8_t* out8, float* scales) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row < p.M) quantize_row<false>(p, row, out8 + (long long)row * p.K, scales + row,
                                     threadIdx.x & 31);
}

Args gemm_args(const void* x, const float* ln_w, const float* ln_b, const int8_t* wq,
               const float* ws, const float* bias, const void* res, void* out, int M, int N,
               int K, float eps) {
  return Args{static_cast<const __nv_bfloat16*>(x), ln_w, ln_b, wq, ws, nullptr, nullptr, bias,
              static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), M, N, K,
              tiles_per_block(M, N), eps, nullptr, nullptr};
}

cudaError_t attention(const void* q, const void* k, const void* v, long long q_row,
                      long long kv_row, const void* mask, void* out, int B, int Lq, int Lk,
                      int H, float c2, cudaStream_t st) {
  AttnArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v), q_row, kv_row,
             static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), Lq, Lk, H, c2};
  attn_kernel<<<dim3((Lq + kQB - 1) / kQB, H, B), kAThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mars5_mega_decoder_stack(
    void* x, const void* mem, const void* tmask, const void* mmask, const void* pack_,
    const void* svec_, const void* bvec_, const void* lnvec_, void* qkv_, void* attn, void* hq,
    void* ckv_, void* u, void* mem8_, void* ms_, int n_layers, int B, int L, int Lk, int D,
    int H, int F, float eps, float c2, void* stream) {
  if (n_layers <= 0 || B <= 0 || L <= 0 || Lk <= 0 || B > 65535 || H <= 0 || H > 65535 ||
      H * kHD != D || D % kKC || D > kMaxK || F <= 0 || F % kKC || F > kMaxK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L, Mk = B * Lk;
  const auto* pack = static_cast<const int8_t*>(pack_);
  const auto* svec = static_cast<const float*>(svec_);
  const auto* bvec = static_cast<const float*>(bvec_);
  const auto* lnvec = static_cast<const float*>(lnvec_);
  auto* qkv = static_cast<__nv_bfloat16*>(qkv_);
  auto* ckv = static_cast<__nv_bfloat16*>(ckv_);
  auto* mem8 = static_cast<int8_t*>(mem8_);
  auto* ms = static_cast<float*>(ms_);
  const long long DD = (long long)D * D, FD = (long long)F * D;
  const long long stage[7] = {0, 3 * DD, 4 * DD, 5 * DD, 7 * DD, 8 * DD, 8 * DD + 2 * FD};
  const long long layer_bytes = 8 * DD + 3 * FD;

  // the memory rows, quantized once for every layer's ca_kv
  Args qa = gemm_args(mem, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, Mk, 0,
                      D, eps);
  quant_rows_kernel<<<(Mk + 3) / 4, 128, 0, st>>>(qa, mem8, ms);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

#define MEGA_TRY(call)              \
  do {                              \
    e = (call);                     \
    if (e != cudaSuccess) return (int)e; \
  } while (0)

  for (int l = 0; l < n_layers; ++l) {
    const int8_t* w = pack + l * layer_bytes;
    const float* sv = svec + (long long)l * (9 * D + 2 * F);
    const float* bv = bvec + (long long)l * 9 * D;
    const float* lv = lnvec + (long long)l * 6 * D;
    // s0: LN1 -> qkv
    MEGA_TRY((launch<true, 0>(gemm_args(x, lv, lv + D, w + stage[0], sv, bv, nullptr, qkv, M,
                                        3 * D, D, eps), st)));
    // self-attention over the qkv rows
    MEGA_TRY(attention(qkv, qkv + D, qkv + 2 * D, 3 * D, 3 * D, tmask, attn, B, L, L, H, c2, st));
    // s1: sa_out + residual, in place
    MEGA_TRY((launch<false, 0>(gemm_args(attn, nullptr, nullptr, w + stage[1], sv + 3 * D,
                                         bv + 3 * D, x, x, M, D, D, eps), st)));
    // s2: LN2 -> ca_q
    MEGA_TRY((launch<true, 0>(gemm_args(x, lv + 2 * D, lv + 3 * D, w + stage[2], sv + 4 * D,
                                        bv + 4 * D, nullptr, hq, M, D, D, eps), st)));
    // s3: ca_kv from the quantized memory
    Args kv = gemm_args(nullptr, nullptr, nullptr, w + stage[3], sv + 5 * D, bv + 5 * D, nullptr,
                        ckv, Mk, 2 * D, D, eps);
    kv.a8 = mem8;
    kv.a8s = ms;
    MEGA_TRY((launch<false, 0>(kv, st)));
    // cross-attention
    MEGA_TRY(attention(hq, ckv, ckv + D, D, 2 * D, mmask, attn, B, L, Lk, H, c2, st));
    // s4: ca_out + residual, in place
    MEGA_TRY((launch<false, 0>(gemm_args(attn, nullptr, nullptr, w + stage[4], sv + 7 * D,
                                         bv + 7 * D, x, x, M, D, D, eps), st)));
    // WV: LN3 -> silu(w) * v
    Args wv = gemm_args(x, lv + 4 * D, lv + 5 * D, w + stage[5], sv + 8 * D, nullptr, nullptr, u,
                        M, F, D, eps);
    wv.vq = w + stage[5] + FD;
    wv.vs = sv + 8 * D + F;
    wv.tiles_per_block = tiles_per_block(M, 2 * F);
    MEGA_TRY((launch<true, 1>(wv, st)));
    // lin2 (K = F): requant of u, + bias + residual, in place
    MEGA_TRY((launch<false, 0>(gemm_args(u, nullptr, nullptr, w + stage[6], sv + 8 * D + 2 * F,
                                         bv + 8 * D, x, x, M, D, F, eps), st)));
  }
#undef MEGA_TRY
  return 0;
}
