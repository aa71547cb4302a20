// The whole W8A8 NAR decoder stack for Hopper (sm_90a): K9 mega_decoder_stack.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/nar_mega.py::_make_kernel
// (entry mega_decoder_stack), which ran every decoder layer as one Pallas
// program with the (B, L, D) stream resident in VMEM. Per layer, the x
// stream in bf16 throughout:
//
//   qkv  = bf16(W8A8(LN1(x)) + b)                            (M, 3D)
//   a    = attention(q, k, v; key-padding mask)                (M, D)
//   x   += bf16(W8A8(a) + b)                                   sa_out
//   hq   = bf16(W8A8(LN2(x)) + b)                              ca_q
//   ckv  = bf16(W8A8(mem8) + b)                                ca_kv (B Lk, 2D)
//   a    = attention(hq, ck, cv; memory mask)
//   x   += bf16(W8A8(a) + b)                                   ca_out
//   u    = bf16(bf16(silu(w)) * v), w, v = bf16(W8A8(LN3(x)))  WV (M, F)
//   x   += bf16(W8A8(u) + b)                                   lin2
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
//   (B L, D), ckv (B Lk, 2D), u (B L, F) bf16; q8 (B L, max(D, F)) int8 and
//   xs (B L) f32, the A operand of the GEMM sites; mem8 (B Lk, D) int8, ms
//   (B Lk) f32. plan: the (tile width, grid) of the seven GEMM sites in the
//   order above (ops/kernels/nar_mega.py mega_plan).
//
// What bounds it here: at the bench geometry (2 x 1200 rows, D 1024, F 3072,
// 16 layers) one call is 1.21 T int8 ops of GEMM (0.61 ms at 1,979 TOP/s),
// 0.19 TFLOP of bf16 attention a pass over the keys and 285 MB of weights
// (85 us at 3.35 TB/s): the tensor cores bound it, and only wgmma drives them
// at their rate. What the design does about it:
// - The seven GEMM sites are those of K3/K4 (w8a8_wgmma.cuh): a per-row
//   prologue kernel (LN when the site has one, then the row's int8 quant,
//   once a row) writes q8 / xs, and the persistent, warp-specialised,
//   TMA-fed wgmma s8 GEMM takes them as its A operand (mode 0: rescale,
//   bias, residual, in place on x; mode 1: SwiGLU for WV). ca_kv takes mem8
//   / ms. The host picks each site's tile width and grid (mega_plan: the
//   tile whose last wave ends first).
// - Both attentions run on wgmma (mega_attn_kernel, K1's design in
//   csrc/mha.cu): three consumer warpgroups of 64 query rows and a producer
//   warp that feeds a two-stage K/V ring by TMA through 4-D tensor maps
//   reading q, k and v in place as strided views of the qkv scratch (self)
//   and of hq and ckv (cross); S = Q K^T on m64n128k16 with Q and K K-major,
//   O += P V with P from registers and V through the descriptor's transpose
//   bit. The contract is the twin's full-row softmax, not K1's online one,
//   so the ring walks the keys twice: pass 1 loads K alone and takes each
//   row's max; pass 2 loads K and V, forms p = exp2((s - max) * c2), its
//   row sum in f64 and P V. The key-padding mask and the ragged last tile
//   are a 0 / -inf bias row; TMA zero-fills rows past Lq and Lk.
// - The TPU program held the stream in VMEM across layers; here one C entry
//   issues 1 + 15 launches a layer with no host work between them, and the
//   activations (44 MB at the bench geometry) live in device scratch, most
//   of it served from the 50 MB L2.
//
// Numerics: the GEMM sites are K3/K4's bit for bit. Both attentions: s = q.k
// in f32 (bf16 wgmma), p = exp2((s - max s) * c2) with c2 = scale * log2(e),
// the row sum of the unrounded p in f64 rounded once, p rounded to bf16
// before PV (f32 accumulation), o / sum last: the twin's
// mega_decoder_stack_ref.
//
// The C entry returns the first error (cudaGetLastError() after each launch),
// or cudaErrorInvalidValue for arguments it does not take.

#include "w8a8_wgmma.cuh"

namespace {

// ---- attention: two passes over a TMA-fed K/V ring -------------------------

constexpr int kHD = 64;                       // head dim
constexpr int kRow = kHD * 2;                 // bytes of a bf16 head row: one swizzle row
constexpr int kAConsumers = 3;                // consumer warpgroups, 64 query rows each
constexpr int kAQ = 64 * kAConsumers;         // queries a CTA
constexpr int kAK = 128;                      // keys a ring stage
constexpr int kAStages = 2;
constexpr int kAThreads = kWarpgroup * (kAConsumers + 1);
constexpr int kAProducerRegs = 32, kAConsumerRegs = 160;   // 128 x 32 + 384 x 160 = 64 K

// Shared memory from a 1024-byte aligned base: Q (kAQ rows); per stage K then
// V (kAK rows each); per stage the bias row (kAK floats); the barriers
// full[kAStages], empty[kAStages], q.
constexpr int kAOffKV = kAQ * kRow;
constexpr int kAStageBytes = 2 * kAK * kRow;
constexpr int kAOffBias = kAOffKV + kAStages * kAStageBytes;
constexpr int kAOffBars = kAOffBias + kAStages * kAK * 4;
constexpr int kASmem = kAOffBars + (2 * kAStages + 1) * 8 + 1024;   // + alignment slack

__global__ void __launch_bounds__(kAThreads, 1)
mega_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int Lq, int Lk, int H, float c2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  float* bias = reinterpret_cast<float*>(smem + kAOffBias);
  const uint32_t full = base + kAOffBars, empty = full + 8 * kAStages, qbar = empty + 8 * kAStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kAQ;
  const int wg = threadIdx.x / kWarpgroup;
  const int n_tiles = (Lk + kAK - 1) / kAK;
  const int active = min(kAConsumers, (Lq - q0 + 63) / 64);   // warpgroups with rows < Lq

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, kWarpgroup * active);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kAConsumers) {
    // ---- producer warpgroup: its first warp loads, the other three leave.
    // Ring tiles t < n_tiles are pass 1 (K alone), the next n_tiles pass 2.
    warpgroup_regs_dec<kAProducerRegs>();
    if ((threadIdx.x >> 5) != kAConsumers * 4) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, kAQ * kRow);
      tma_load_4d(base, &tq, qbar, 0, h, q0, b);
    }
    const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Lk : nullptr;
    for (int t = 0; t < 2 * n_tiles; ++t) {
      const int s = t % kAStages, k0 = (t % n_tiles) * kAK;
      const bool pv = t >= n_tiles;
      mbar_wait(empty + 8 * s, ((t / kAStages) & 1) ^ 1);
#pragma unroll
      for (int i = lane; i < kAK; i += 32) {
        const int key = k0 + i;
        bias[s * kAK + i] = (key >= Lk || (mrow != nullptr && mrow[key])) ? -INFINITY : 0.f;
      }
      if (lane == 0) {
        const uint32_t kd = base + kAOffKV + s * kAStageBytes;
        mbar_arrive_expect_tx(full + 8 * s, pv ? kAStageBytes : kAK * kRow);
        tma_load_4d(kd, &tk, full + 8 * s, 0, h, k0, b);
        if (pv) tma_load_4d(kd + kAK * kRow, &tv, full + 8 * s, 0, h, k0, b);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup c: query rows q0 + 64 c .. + 63
  warpgroup_regs_inc<kAConsumerRegs>();
  const int c = wg;
  if (c >= active) return;
  const int tid = threadIdx.x % kWarpgroup, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t qa = base + c * 64 * kRow;
  float sc[kAK / 2];

  // S = Q K^T of ring tile t plus the tile's bias, rows g and g + 8 of this warp
  auto scores = [&](int t) {
    const int s = t % kAStages;
    mbar_wait(full + 8 * s, (t / kAStages) & 1);
    const uint32_t ka = base + kAOffKV + s * kAStageBytes;
#pragma unroll
    for (int i = 0; i < kAK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk)
      wgmma_m64n128k16_ss(sc, wgmma_desc_sw128(qa + 32 * kk, 0, 1024),
                          wgmma_desc_sw128(ka + 32 * kk, 0, 1024), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kAK / 2>(sc);
    const float* bs = bias + s * kAK;
#pragma unroll
    for (int j = 0; j < kAK / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * tq4);
      sc[4 * j] = __fadd_rn(sc[4 * j], bj.x);
      sc[4 * j + 1] = __fadd_rn(sc[4 * j + 1], bj.y);
      sc[4 * j + 2] = __fadd_rn(sc[4 * j + 2], bj.x);
      sc[4 * j + 3] = __fadd_rn(sc[4 * j + 3], bj.y);
    }
  };

  mbar_wait(qbar, 0);
  // pass 1: each row's max over all keys
  float mx[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < n_tiles; ++t) {
    scores(t);
#pragma unroll
    for (int i = 0; i < kAK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    mbar_arrive(empty + 8 * (t % kAStages));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // pass 2: p, its f64 row sum, and O += P V
  float o[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
  double rs[2] = {0.0, 0.0};
  for (int t = n_tiles; t < 2 * n_tiles; ++t) {
    scores(t);
    const int s = t % kAStages;
    const uint32_t va = base + kAOffKV + s * kAStageBytes + kAK * kRow;
#pragma unroll
    for (int i = 0; i < kAK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(__fmul_rn(__fsub_rn(sc[i], mx[r]), c2));
      sc[i] = p;
      rs[r] += (double)p;
    }
    // the S accumulators of key chunks 2 kk and 2 kk + 1 are the A fragment
    // of the 16-key slice kk
    uint32_t pa[kAK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kAK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAK / 16; ++kk)
      wgmma_m64n64k16_rs_mn(o, pa[kk], wgmma_desc_sw128(va + 16 * kRow * kk, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kHD / 2>(o);
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    const float sum = (float)rs[r];
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * kHD;
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq4) =
          pack_bf16(__fdiv_rn(o[4 * j + 2 * r], sum), __fdiv_rn(o[4 * j + 2 * r + 1], sum));
  }
}

// The 4-D map (head dim, heads, sequence, batch) of a bf16 (B, L, H, 64) view
// whose rows are ``row`` elements apart (the batch L rows apart); boxes of
// ``rows`` positions of one head, 128-byte swizzle, zero fill past L.
bool encode_heads(CUtensorMap* map, const void* ptr, int B, int L, int H, long long row,
                  int rows) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {kHD, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {kRow, (cuuint64_t)row * 2, (cuuint64_t)row * L * 2};
  const cuuint32_t box[4] = {kHD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The three maps of one attention: q rows ``q_row`` apart, k and v rows
// ``kv_row`` apart.
struct AttnMaps {
  CUtensorMap q, k, v;
  bool encode(const void* qp, const void* kp, const void* vp, long long q_row, long long kv_row,
              int B, int Lq, int Lk, int H) {
    return encode_heads(&q, qp, B, Lq, H, q_row, kAQ) &&
           encode_heads(&k, kp, B, Lk, H, kv_row, kAK) &&
           encode_heads(&v, vp, B, Lk, H, kv_row, kAK);
  }
};

cudaError_t attention(const AttnMaps& m, const void* mask, void* out, int B, int Lq, int Lk,
                      int H, float c2, cudaStream_t st) {
  static std::atomic<unsigned> smem_set{0};   // one bit a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !(smem_set.load() & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kASmem);
    if (err != cudaSuccess) return err;
    if (dev < 32) smem_set.fetch_or(1u << dev);
  }
  mega_attn_kernel<<<dim3(B * H, (Lq + kAQ - 1) / kAQ), kAThreads, kASmem, st>>>(
      m.q, m.k, m.v, static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), Lq,
      Lk, H, c2);
  return cudaGetLastError();
}

// ---- GEMM sites ------------------------------------------------------------

enum Site { kQkv, kSaOut, kCaQ, kCaKv, kCaOut, kWV, kLin2, kSites };

long long kernel_launches = 0;          // kernels this library has launched

// A mode-0 site: out = bf16(acc * (xs * ws) + bias) [+ res] over A (ta) and
// the weight w (N, K) in bn-wide tiles.
cudaError_t gemm0(const int* plan, int site, const CUtensorMap& ta, const int8_t* w,
                  const float* xs, const float* ws, const float* bias, const __nv_bfloat16* res,
                  __nv_bfloat16* out, int M, int N, int K, cudaStream_t st) {
  const int bn = plan[2 * site], grid = plan[2 * site + 1];
  CUtensorMap tw;
  if (!encode_map_s8(&tw, w, N, K, bn)) return cudaErrorInvalidValue;
  const Epilogue p{xs, ws, nullptr, bias, res, out, M, N, K};
  return launch_gemm0(bn, false, grid, st, ta, tw, p);
}

bool bad_plan(const int* plan, int D, int F) {
  for (int s = 0; s < kSites; ++s)
    if ((plan[2 * s] != 128 && plan[2 * s] != 256) || plan[2 * s + 1] <= 0) return true;
  return F % (plan[2 * kWV] / 2) != 0;   // mode 1 reads whole tiles of V's scales
}

}  // namespace

extern "C" int mars5_mega_decoder_stack(
    void* x_, const void* mem, const void* tmask, const void* mmask, const void* pack_,
    const void* svec_, const void* bvec_, const void* lnvec_, void* qkv_, void* attn_, void* hq_,
    void* ckv_, void* u_, void* q8_, void* xs_, void* mem8_, void* ms_, const int* plan,
    int n_layers, int B, int L, int Lk, int D, int H, int F, float eps, float c2, void* stream) {
  if (n_layers <= 0 || B <= 0 || L <= 0 || Lk <= 0 || H <= 0 || (long long)B * H > 0x7fffffff ||
      (L + kAQ - 1) / kAQ > 65535 || H * kHD != D || D % kBK || D > kMaxK || F <= 0 ||
      F % kBK || F > kMaxK || plan == nullptr || bad_plan(plan, D, F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L, Mk = B * Lk;
  auto* x = static_cast<__nv_bfloat16*>(x_);
  const auto* pack = static_cast<const int8_t*>(pack_);
  const auto* svec = static_cast<const float*>(svec_);
  const auto* bvec = static_cast<const float*>(bvec_);
  const auto* lnvec = static_cast<const float*>(lnvec_);
  auto* qkv = static_cast<__nv_bfloat16*>(qkv_);
  auto* attn = static_cast<__nv_bfloat16*>(attn_);
  auto* hq = static_cast<__nv_bfloat16*>(hq_);
  auto* ckv = static_cast<__nv_bfloat16*>(ckv_);
  auto* u = static_cast<__nv_bfloat16*>(u_);
  auto* q8 = static_cast<int8_t*>(q8_);
  auto* xs = static_cast<float*>(xs_);
  auto* mem8 = static_cast<int8_t*>(mem8_);
  auto* ms = static_cast<float*>(ms_);
  const long long DD = (long long)D * D, FD = (long long)F * D;
  const long long stage[kSites] = {0, 3 * DD, 4 * DD, 5 * DD, 7 * DD, 8 * DD, 8 * DD + 2 * FD};
  const long long layer_bytes = 8 * DD + 3 * FD;

  // the maps of the scratch, once a call: the A operands (q8 at K = D and
  // K = F, mem8) and both attentions' q, k, v views
  CUtensorMap ta_d, ta_f, ta_mem;
  AttnMaps self_maps, cross_maps;
  if (!encode_map_s8(&ta_d, q8, M, D, kBM) || !encode_map_s8(&ta_f, q8, M, F, kBM) ||
      !encode_map_s8(&ta_mem, mem8, Mk, D, kBM) ||
      !self_maps.encode(qkv, qkv + D, qkv + 2 * D, 3 * D, 3 * D, B, L, L, H) ||
      !cross_maps.encode(hq, ckv, ckv + D, D, 2 * D, B, L, Lk, H))
    return (int)cudaErrorInvalidValue;

  cudaError_t e;
#define MEGA_LAUNCH(call)                  \
  do {                                     \
    e = (call);                            \
    if (e != cudaSuccess) return (int)e;   \
    ++kernel_launches;                     \
  } while (0)

  // the memory rows, quantized once for every layer's ca_kv
  MEGA_LAUNCH(launch_prologue(static_cast<const __nv_bfloat16*>(mem), nullptr, nullptr, 0, eps,
                              mem8, ms, Mk, D, st));
  for (int l = 0; l < n_layers; ++l) {
    const int8_t* w = pack + l * layer_bytes;
    const float* sv = svec + (long long)l * (9 * D + 2 * F);
    const float* bv = bvec + (long long)l * 9 * D;
    const float* lv = lnvec + (long long)l * 6 * D;
    // LN1 -> qkv
    MEGA_LAUNCH(launch_prologue(x, lv, lv + D, 0, eps, q8, xs, M, D, st));
    MEGA_LAUNCH(gemm0(plan, kQkv, ta_d, w + stage[kQkv], xs, sv, bv, nullptr, qkv, M, 3 * D, D,
                      st));
    // self-attention over the qkv rows
    MEGA_LAUNCH(attention(self_maps, tmask, attn, B, L, L, H, c2, st));
    // sa_out + residual, in place
    MEGA_LAUNCH(launch_prologue(attn, nullptr, nullptr, 0, eps, q8, xs, M, D, st));
    MEGA_LAUNCH(gemm0(plan, kSaOut, ta_d, w + stage[kSaOut], xs, sv + 3 * D, bv + 3 * D, x, x, M,
                      D, D, st));
    // LN2 -> ca_q
    MEGA_LAUNCH(launch_prologue(x, lv + 2 * D, lv + 3 * D, 0, eps, q8, xs, M, D, st));
    MEGA_LAUNCH(gemm0(plan, kCaQ, ta_d, w + stage[kCaQ], xs, sv + 4 * D, bv + 4 * D, nullptr, hq,
                      M, D, D, st));
    // ca_kv from the quantized memory
    MEGA_LAUNCH(gemm0(plan, kCaKv, ta_mem, w + stage[kCaKv], ms, sv + 5 * D, bv + 5 * D, nullptr,
                      ckv, Mk, 2 * D, D, st));
    // cross-attention
    MEGA_LAUNCH(attention(cross_maps, mmask, attn, B, L, Lk, H, c2, st));
    // ca_out + residual, in place
    MEGA_LAUNCH(launch_prologue(attn, nullptr, nullptr, 0, eps, q8, xs, M, D, st));
    MEGA_LAUNCH(gemm0(plan, kCaOut, ta_d, w + stage[kCaOut], xs, sv + 7 * D, bv + 7 * D, x, x, M,
                      D, D, st));
    // LN3 -> WV: u = silu(w) * v, bn / 2 rows of W and of V a tile
    MEGA_LAUNCH(launch_prologue(x, lv + 4 * D, lv + 5 * D, 0, eps, q8, xs, M, D, st));
    {
      const int bn = plan[2 * kWV];
      CUtensorMap tw, tv;
      if (!encode_map_s8(&tw, w + stage[kWV], F, D, bn / 2) ||
          !encode_map_s8(&tv, w + stage[kWV] + FD, F, D, bn / 2))
        return (int)cudaErrorInvalidValue;
      const Epilogue p{xs, sv + 8 * D, sv + 8 * D + F, nullptr, nullptr, u, M, F, D};
      MEGA_LAUNCH(launch_swiglu(bn, plan[2 * kWV + 1], st, ta_d, tw, tv, p));
    }
    // lin2 (K = F): requant of u, + bias + residual, in place
    MEGA_LAUNCH(launch_prologue(u, nullptr, nullptr, 0, eps, q8, xs, M, F, st));
    MEGA_LAUNCH(gemm0(plan, kLin2, ta_f, w + stage[kLin2], xs, sv + 8 * D + 2 * F, bv + 8 * D, x,
                      x, M, D, F, st));
  }
#undef MEGA_LAUNCH
  return 0;
}

// Kernels launched by this library so far (1 + 15 a layer a call).
extern "C" long long mars5_mega_kernel_launches() { return kernel_launches; }
