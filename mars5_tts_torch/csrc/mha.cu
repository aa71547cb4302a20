// Bidirectional multi-head attention forward for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/mha.py::_mha_kernel
// (public entry sdpa_pallas; quantized=True below): the NAR decoder's long
// self-attention (bf16 NAR: Lq = Lk; int8 NAR: q, k, v strided views of one
// (B, L, 3 D) projection, the last layer 750 queries over 1,200 keys) and the
// speaker encoders' self-attention once the sequence reaches 512 frames.
//
//   q (B, Lq, H, 64), k/v (B, Lk, H, 64), bf16 or f32, unit stride on the
//   head dim, the other strides multiples of 16 bytes; optional key-padding
//   mask (B, Lk) uint8, nonzero = ignore. Output (B, Lq, H, 64) contiguous,
//   in q's dtype. Scores and softmax in f32: s = q.k, p = exp2((s - max s) *
//   scale * log2e), o = (p @ v) / sum(p), with p rounded to the input dtype
//   before the PV product (as the Pallas kernel does) and the row sum taken
//   in f32 from the unrounded p.
//
// What bounds it on an H100: at the NAR shape (2, 1200, 16, 64) one call
// moves ~20 MB and does ~11.8 GFLOP, ~600 FLOP a byte, so the tensor cores
// bound it (10.9 us at the H100 SXM's data-sheet bf16 peak, 989 TFLOP/s at
// 700 W), and only wgmma reaches their rate.
//
// The bf16 kernel (what the design does about it):
// - A CTA takes 192 queries of one (batch, head): three consumer warpgroups
//   of 64 rows each and one producer warpgroup (512 threads).
// - Both products run on wgmma, bf16 in, f32 accumulate: S = Q K^T with Q
//   and K K-major in shared memory (m64n128k16), O += P V with P from
//   registers as the A operand and V the MN-major B operand, read through
//   the descriptor's transpose bit (m64n64k16): V is never transposed by
//   hand.
// - The key loop is pipelined: a ring of two 128-key K/V stages. One
//   producer thread loads Q once and each K/V tile with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle) through 4-D tensor maps
//   (dims head dim, heads, sequence, batch) that address the strided views
//   in place; the other 31 lanes of its warp turn the tile's key-padding
//   mask and ragged tail into a 0 / -inf bias row in shared memory. A full
//   mbarrier per stage (TMA bytes + the 32 lanes) releases the tile to the
//   consumers, an empty one (every consumer thread) hands the stage back, so
//   the loads of tile t + 1 run while the consumers compute on tile t.
// - Online softmax in registers with the running max and sum per row; the
//   scores never reach memory; one division at the end. TMA zero-fills rows
//   past Lq and Lk; the bias masks the keys past Lk. A consumer warpgroup
//   whose 64 rows all lie past Lq takes no part.
// - Registers: setmaxnreg gives the producer 32 a thread and each consumer
//   160 (S 64, O 32, P 32 a thread); one CTA a SM (88 KB of shared memory).
// - Waves at (2, 1200, 16, 64): 7 query tiles x 32 (batch, head) = 224 CTAs
//   on 132 SMs, 1.70 waves; the 32 CTAs of the last tile (48 rows) run one
//   consumer warpgroup and are launched last (grid x = batch x head, grid y =
//   query tile). The int8 NAR's last layer (750 queries) gives 4 x 32 = 128
//   CTAs, 0.97 of a wave.
// - cuTensorMapEncodeTiled comes from the runtime (hopper.cuh
//   tensor_map_encoder), so the library needs no -lcuda; the three maps are
//   encoded at each call.
//
// The f32 kernel (not on the default path) keeps a query row a thread in
// registers and walks 32-key tiles of K and V in shared memory.
//
// The int8 mode (mars5_mha_int8_fwd; _mha_kernel(quantized=True), the W8A8
// NAR's attention under MARS5_QATTN), per (batch, head), bf16 in and out:
//   q8, qs = quant_rows(q); k8, ks = quant_rows(k)  (per 64-value row:
//     qs = max(amax, 1e-8) / 127, q8 = rint(q / qs) clipped to +-127)
//   s = (float(q8 . k8) * (qs * scale)) * ks, -inf on masked keys and keys
//     past Lk; m = the row's max over all keys; p = exp2((s - m) * log2e);
//     r = sum p (f32)
//   v8, vs per channel over all Lk keys (masked ones included)
//   o = (float(rint(p * 127) . v8) * (vs / 127)) / r
// p is rounded to int8 against the full row's max, so the keys are walked
// twice: pass 1 takes the max, pass 2 the exponentials, their sum and the PV
// product (an online softmax would round other integers). What bounds it:
// at (2, 1200, 16, 64) one call moves ~20 MB (5.9 us at 3.35 TB/s) and
// does 11.8 G int8 operations a pass (6.0 us at 1,979 TOP/s), so only wgmma
// s8 and operands staged once in shared memory come near it. The design:
// - Three launches. Pre-pass one (a block a 64 keys of one (batch, head),
//   the whole card busy): k's rows int8 into k8 (B H, Lk, 64) with ks, and
//   each block's per-channel max |v| (exact in any order). Pre-pass two: vs
//   from those maxima, then v8 transposed to (B H, 64, Lkp) (K-major: wgmma
//   takes 8-bit operands K-major only), its keys permuted inside each
//   32-key block (v8_key, below). q is quantized inside the attention.
// - The attention is the bf16 kernel's shape: a CTA takes 192 queries of
//   one (batch, head), three consumer warpgroups of 64 rows and a producer
//   warpgroup (setmaxnreg 32 / 160), grid (B H, query tiles) with the ragged
//   last tile launched last. TMA brings the bf16 q rows through the bf16
//   kernel's 4-D map; each consumer warp takes its 16 rows' amax, writes q8
//   into a 64-byte-swizzled A tile and keeps qs * scale of its rows in
//   registers.
// - A four-stage ring of 128-key tiles: k8 (128 x 64 B, 64-byte swizzle)
//   and v8t (64 x 128 B, 128-byte swizzle) by TMA through 3-D maps over the
//   scratch that zero-fill past Lk; the producer warp's lanes write each
//   tile's ks and a 0 / -inf bias row (masked keys, keys past Lk) into the
//   stage, so nothing in the key loop reads global memory. Ring tiles t <
//   n_tiles are pass 1 (k8 alone), the next n_tiles pass 2 (k8 and v8t).
// - S = Q8 K8^T on wgmma m64n128k32 s8 (two k32 steps); pass 1 takes s and
//   each row's max; pass 2 takes s again, p, the f32 row sum, and packs p8
//   straight into the register A operand of O += P8 V8t on m64n64k32 s8. A
//   thread's accumulators hold keys {2t, 2t + 1, 8 + 2t, 9 + 2t} (+ 16) of
//   its rows where the 8-bit A layout wants keys 4t .. 4t + 3 (+ 16); v8t
//   stores its keys in that order inside each 32-key block (v8_key; the
//   PV sum is exact in any order), so no register moves. The int32 PV sum
//   is at most 127^2 Lk, far inside int32 for any NAR length.
// - The score math, not the tensor cores, holds the attention: a score
//   costs about 20 instructions over both passes against 4 s8 MACs. Three
//   of them ran on the quarter-rate conversion / MUFU unit (the s32 -> f32
//   conversion, exp2f, rint(p * 127) to int), so pass 1 converts by a
//   1.5 x 2^23 integer and f32 add, p8 is the low byte of p * 127 + 1.5 x
//   2^23, and 2^x is one ex2.approx.ftz: each exact for these ranges
//   (|acc| < 2^22; 0 <= p * 127 <= 127; p < 2^-126 gives p8 0 either way).
// - Epilogue: o = float(acc) * (vs / 127) / r, vs / 127 staged once a CTA.
//
// The C entry point returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments or views it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <chrono>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kD = 64;              // head dim supported
constexpr int kRow = kD * 2;        // bytes of one bf16 row: one 128-byte swizzle row

// ---- bf16: wgmma, TMA, warp-specialised
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 3;                      // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kConsumers;               // queries a CTA
constexpr int kBN = 128;                           // keys a K/V stage
constexpr int kStages = 2;                         // depth of the K/V ring
constexpr int kThreads = kWarpgroup * (kConsumers + 1);
constexpr int kProducerRegs = 32, kConsumerRegs = 160;  // 128 x 32 + 384 x 160 = 64 K

// Shared memory, from a 1024-byte aligned base: Q (kBM rows); per stage K
// then V (kBN rows each); per stage the bias row (kBN floats); the barriers
// full[kStages], empty[kStages], q.
constexpr int kOffKV = kBM * kRow;
constexpr int kStageBytes = 2 * kBN * kRow;
constexpr int kOffBias = kOffKV + kStages * kStageBytes;
constexpr int kOffBars = kOffBias + kStages * kBN * 4;
constexpr int kSmemBytes = kOffBars + (2 * kStages + 1) * 8 + 1024;   // + alignment slack

__global__ void __launch_bounds__(kThreads, 1)
mha_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, int Lq, int Lk, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  float* bias = reinterpret_cast<float*>(smem + kOffBias);
  const uint32_t full = base + kOffBars, empty = full + 8 * kStages, qbar = empty + 8 * kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / kWarpgroup;
  const int n_tiles = (Lk + kBN - 1) / kBN;
  const int active = min(kConsumers, (Lq - q0 + 63) / 64);   // warpgroups with rows < Lq

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, kWarpgroup * active);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: its first warp loads, the other three leave
    warpgroup_regs_dec<kProducerRegs>();
    if ((threadIdx.x >> 5) != kConsumers * 4) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, kBM * kRow);
      tma_load_4d(base, &tq, qbar, 0, h, q0, b);
    }
    const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Lk : nullptr;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, k0 = t * kBN;
      mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
#pragma unroll
      for (int i = lane; i < kBN; i += 32) {
        const int key = k0 + i;
        bias[s * kBN + i] = (key >= Lk || (mrow != nullptr && mrow[key])) ? -INFINITY : 0.f;
      }
      if (lane == 0) {
        const uint32_t kd = base + kOffKV + s * kStageBytes;
        mbar_arrive_expect_tx(full + 8 * s, kStageBytes);
        tma_load_4d(kd, &tk, full + 8 * s, 0, h, k0, b);
        tma_load_4d(kd + kBN * kRow, &tv, full + 8 * s, 0, h, k0, b);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup c: query rows q0 + 64 c .. + 63
  warpgroup_regs_inc<kConsumerRegs>();
  const int c = wg;
  if (c >= active) return;
  const int tid = threadIdx.x % kWarpgroup, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t qa = base + c * 64 * kRow;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp, raw score units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    const uint32_t ka = base + kOffKV + s * kStageBytes, va = ka + kBN * kRow;

    // S = Q K^T: 64 rows x kBN keys, 4 steps of 16 along the head dim
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint64_t da = wgmma_desc_sw128(qa + 32 * kk, 0, 1024);
      const uint64_t db = wgmma_desc_sw128(ka + 32 * kk, 0, 1024);
      wgmma_m64n128k16_ss(sc, da, db, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBN / 2>(sc);

    // key padding (0 / -inf bias), then the online softmax of rows g, g + 8
    const float* bs = bias + s * kBN;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * tq4);
      sc[4 * j] += bj.x;
      sc[4 * j + 1] += bj.y;
      sc[4 * j + 2] += bj.x;
      sc[4 * j + 3] += bj.y;
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float base_r[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base_r[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // all keys masked so far
      corr[r] = exp2f((m_run[r] - base_r[r]) * scale_log2);
      m_run[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float p = exp2f((sc[i] - base_r[(i >> 1) & 1]) * scale_log2);
      sc[i] = p;
      rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: the S accumulators of key chunks 2 kk and 2 kk + 1 are the
    // A fragment of the 16-key slice kk
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_m64n64k16_rs_mn(o, pa[kk], wgmma_desc_sw128(va + 16 * kRow * kk, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(o);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq4) =
          pack_bf16(o[4 * j + 2 * r] / l_run[r], o[4 * j + 2 * r + 1] / l_run[r]);
  }
}

struct Strides {
  long long b, l, h;            // element strides of the batch, sequence, head axes
};

// ---- f32 inputs: one thread per query row, q and the output row in registers,
// 32-key tiles of K and V in shared memory (read as broadcasts).
constexpr int kFRows = 64;
constexpr int kFKeys = 32;

__global__ void __launch_bounds__(kFRows)
mha_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int Lq, int Lk, int H, Strides sq,
                   Strides sk, Strides sv, float scale_log2) {
  __shared__ __align__(16) float Ks[kFKeys][kD];
  __shared__ __align__(16) float Vs[kFKeys][kD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kFRows + threadIdx.x;
  const bool live = row < Lq;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const uint8_t* mb = mask ? mask + (long long)b * Lk : nullptr;

  float qr[kD], o[kD];
  const float* qrow = q + b * sq.b + h * sq.h + (long long)(live ? row : 0) * sq.l;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = live ? qrow[d] : 0.f;
    o[d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kFKeys) {
    __syncthreads();
    for (int c = threadIdx.x; c < kFKeys * (kD / 4); c += kFRows) {
      const int r = c / (kD / 4), col = (c % (kD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const float4*>(kb + (long long)(k0 + r) * sk.l + col);
        vv = *reinterpret_cast<const float4*>(vb + (long long)(k0 + r) * sv.l + col);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
    }
    __syncthreads();

    float s[kFKeys];
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kFKeys; ++j) {
      const int key = k0 + j;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc = fmaf(qr[d], Ks[j][d], acc);
      s[j] = (key >= Lk || (mb != nullptr && mb[key])) ? -INFINITY : acc;
      mx = fmaxf(mx, s[j]);
    }
    const float base = mx == -INFINITY ? 0.f : mx;
    const float corr = exp2f((m_run - base) * scale_log2);
    m_run = mx;
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] *= corr;
#pragma unroll
    for (int j = 0; j < kFKeys; ++j) {
      const float p = exp2f((s[j] - base) * scale_log2);
      l_run += p;
#pragma unroll
      for (int d = 0; d < kD; ++d) o[d] = fmaf(p, Vs[j][d], o[d]);
    }
  }

  if (!live) return;
  float* orow = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) orow[d] = o[d] / l_run;
}


// ---- int8 mode (see the header): a two-launch pre-pass over k and v, then
// a two-pass wgmma s8 attention with q quantized inside
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPreKeys = 64;        // keys a pre-pass block
constexpr int kVBlock = 32;         // v8t's keys are padded to it: one k32 step of PV
constexpr int kQ8Row = kD;          // bytes of an int8 q or k row: one 64-byte swizzle row
constexpr int kI8Stages = 4;        // depth of the int8 K/V ring
constexpr int kI8TileK = kBN * kQ8Row;     // k8 tile: 128 keys x 64 bytes, 64-byte swizzle
constexpr int kI8TileV = kD * kBN;         // v8t tile: 64 channels x 128 keys, 128-byte swizzle
constexpr int kI8Stage = kI8TileK + kI8TileV;

// Shared memory, from a 1024-byte aligned base: Q bf16 (kBM rows, TMA); Q8
// (kBM rows of 64 bytes, written by the consumers); per stage k8 then v8t;
// per stage ks then the bias row (kBN floats each); vs / 127 (kD floats);
// the barriers full[kI8Stages], empty[kI8Stages], q.
constexpr int kI8OffQ8 = kBM * kRow;
constexpr int kI8OffKV = kI8OffQ8 + kBM * kQ8Row;
constexpr int kI8OffKs = kI8OffKV + kI8Stages * kI8Stage;
constexpr int kI8OffBias = kI8OffKs + kI8Stages * kBN * 4;
constexpr int kI8OffVsd = kI8OffBias + kI8Stages * kBN * 4;
constexpr int kI8OffBars = kI8OffVsd + kD * 4;
constexpr int kI8Smem = kI8OffBars + (2 * kI8Stages + 1) * 8 + 1024;   // + alignment slack
static_assert(kI8OffQ8 % 1024 == 0 && kI8OffKV % 1024 == 0 && kI8Stage % 1024 == 0,
              "swizzled tiles must start on 1024-byte boundaries");

__device__ __forceinline__ int quant127(float v, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

// 1.5 x 2^23: for |i| < 2^22, float(i) is the bits of this value plus i, less
// this value (exact; an integer and an f32 add in place of the conversion
// unit's quarter-rate I2F); for 0 <= x < 2^22, the f32 sum x + this value
// holds rint(x) (round half to even, as __float2int_rn) in its low bits.
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

// 2^x as one MUFU.EX2: exp2f's own rounding (ex2.approx), with results below
// 2^-126 flushed to 0, which leaves p8 (0 there) and the row sum (>= 1 from
// the row's max) as they are, without exp2f's fix-ups for them.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint16_t pack_s8x2(int lo, int hi) {
  return (uint16_t)((uint32_t)(uint8_t)lo | ((uint32_t)(uint8_t)hi << 8));
}

// Key order inside each 32-key block of v8t: position 4 t + i (+ 16) holds
// key {2t, 2t + 1, 8 + 2t, 9 + 2t}[i] (+ 16), the keys a thread's QK
// accumulators give it.
__device__ __forceinline__ int v8_key(int p) {
  const int r = p & 15, t = r >> 2, i = r & 3;
  return (p & ~15) + (i < 2 ? 2 * t + i : 6 + 2 * t + i);
}

// Launch one: a block a (64-key block, (batch, head)), a warp a key at a
// time: k's rows int8 into k8 (B H, Lk, 64) with their scales ks (B H, Lk),
// and the block's per-channel max |v| into vmax (B H, n_kb, 64).
__global__ void __launch_bounds__(256)
mha_int8_prepass_k(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                   int Lk, int H, Strides sk, Strides sv, int8_t* __restrict__ k8,
                   float* __restrict__ ks, float* __restrict__ vmax, int n_kb) {
  __shared__ float red[8][kD];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * kPreKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  float m0 = 0.f, m1 = 0.f;
  for (int key = k0 + warp; key < min(Lk, k0 + kPreKeys); key += 8) {
    const float2 kf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(kb + key * sk.l + 2 * lane));
    const float2 vf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vb + key * sv.l + 2 * lane));
    const float s = __fdiv_rn(fmaxf(warp_max(fmaxf(fabsf(kf.x), fabsf(kf.y))), 1e-8f), 127.f);
    const long long row = (long long)bh * Lk + key;
    *reinterpret_cast<uint16_t*>(k8 + row * kD + 2 * lane) =
        pack_s8x2(quant127(kf.x, s), quant127(kf.y, s));
    if (lane == 0) ks[row] = s;
    m0 = fmaxf(m0, fabsf(vf.x));
    m1 = fmaxf(m1, fabsf(vf.y));
  }
  red[warp][2 * lane] = m0;
  red[warp][2 * lane + 1] = m1;
  __syncthreads();
  if (threadIdx.x < kD) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    vmax[((long long)bh * n_kb + blockIdx.x) * kD + threadIdx.x] = m;
  }
}

// Launch two: a block a (64-key block, (batch, head)): v's channel scales vs
// = max(amax, 1e-8) / 127 from the blocks' maxima (four threads a channel;
// written by the first block of each (batch, head)), then the block's keys
// of v, int8, into v8t (B H, 64, Lkp), each channel's keys in v8_key order,
// zeros past Lk. The keys are loaded first and staged in shared memory, so
// that both the reads and the transposed writes are coalesced.
__global__ void __launch_bounds__(256)
mha_int8_prepass_v(const __nv_bfloat16* __restrict__ v, int Lk, int Lkp, int H, Strides sv,
                   const float* __restrict__ vmax, int n_kb, float* __restrict__ vs,
                   int8_t* __restrict__ v8t) {
  constexpr int kPairs = kPreKeys * kD / 2 / 256;   // bf16 pairs of v a thread
  __shared__ float red[4][kD];
  __shared__ float vsc[kD];
  __shared__ float tile[kPreKeys][kD + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * kPreKeys;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  float2 f[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = threadIdx.x + 256 * j, key = i / (kD / 2), c = 2 * (i % (kD / 2));
    f[j] = make_float2(0.f, 0.f);
    if (k0 + key < Lk)
      f[j] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vb + (k0 + key) * sv.l + c));
  }
  {
    const int c = threadIdx.x & (kD - 1), part = threadIdx.x / kD;
    const float* pm = vmax + (long long)bh * n_kb * kD + c;
    float m = 0.f;
#pragma unroll 4
    for (int i = part; i < n_kb; i += 4) m = fmaxf(m, pm[i * kD]);
    red[part][c] = m;
  }
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = threadIdx.x + 256 * j, key = i / (kD / 2), c = 2 * (i % (kD / 2));
    tile[key][c] = f[j].x;
    tile[key][c + 1] = f[j].y;
  }
  __syncthreads();
  if (threadIdx.x < kD) {
    const float m = fmaxf(fmaxf(red[0][threadIdx.x], red[1][threadIdx.x]),
                          fmaxf(red[2][threadIdx.x], red[3][threadIdx.x]));
    const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
    vsc[threadIdx.x] = s;
    if (blockIdx.x == 0) vs[bh * kD + threadIdx.x] = s;
  }
  __syncthreads();
  int8_t* dst = v8t + (long long)bh * kD * Lkp + k0;
#pragma unroll
  for (int i = threadIdx.x; i < kD * kPreKeys / 4; i += 256) {
    const int c = i / (kPreKeys / 4), p0 = (i % (kPreKeys / 4)) * 4;
    if (k0 + p0 >= Lkp) continue;
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = v8_key(p0 + j);
      const int qv = k0 + key < Lk ? quant127(tile[key][c], vsc[c]) : 0;
      packed |= (uint32_t)(uint8_t)qv << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(dst + (long long)c * Lkp + p0) = packed;
  }
}

// Launch three: the attention. Grid (B H, query tiles of kBM), the ragged
// last tile launched last; 512 threads: three consumer warpgroups of 64 query
// rows and a producer warpgroup whose first warp feeds the ring.
__global__ void __launch_bounds__(kThreads, 1)
mha_int8_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk8,
                const __grid_constant__ CUtensorMap tv8, const float* __restrict__ ks,
                const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                __nv_bfloat16* __restrict__ out, int Lq, int Lk, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  float* kss = reinterpret_cast<float*>(smem + kI8OffKs);
  float* bias = reinterpret_cast<float*>(smem + kI8OffBias);
  float* vsd = reinterpret_cast<float*>(smem + kI8OffVsd);
  const uint32_t full = base + kI8OffBars, empty = full + 8 * kI8Stages,
                 qbar = empty + 8 * kI8Stages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / kWarpgroup;
  const int n_tiles = (Lk + kBN - 1) / kBN;
  const int active = min(kConsumers, (Lq - q0 + 63) / 64);   // warpgroups with rows < Lq

  if (threadIdx.x == 0) {
    for (int s = 0; s < kI8Stages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, kWarpgroup * active);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: its first warp loads, the other three leave.
    // Ring tiles t < n_tiles are pass 1 (k8 alone), the next n_tiles pass 2
    // (k8 and v8t); the 32 lanes write each tile's ks and its 0 / -inf bias
    // (masked keys and keys past Lk), so the consumers read neither from
    // global memory.
    warpgroup_regs_dec<kProducerRegs>();
    if ((threadIdx.x >> 5) != kConsumers * 4) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, kBM * kRow);
      tma_load_4d(base, &tq, qbar, 0, h, q0, b);
    }
    for (int c = lane; c < kD; c += 32) vsd[c] = __fdiv_rn(vs[bh * kD + c], 127.f);
    const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Lk : nullptr;
    const float* ksb = ks + (long long)bh * Lk;
    for (int t = 0; t < 2 * n_tiles; ++t) {
      const int s = t % kI8Stages, k0 = (t % n_tiles) * kBN;
      const bool pv = t >= n_tiles;
      mbar_wait(empty + 8 * s, ((t / kI8Stages) & 1) ^ 1);
#pragma unroll
      for (int i = lane; i < kBN; i += 32) {
        const int key = k0 + i;
        const bool in = key < Lk;
        kss[s * kBN + i] = in ? ksb[key] : 0.f;
        bias[s * kBN + i] = (!in || (mrow != nullptr && mrow[key])) ? -INFINITY : 0.f;
      }
      if (lane == 0) {
        const uint32_t kd = base + kI8OffKV + s * kI8Stage;
        mbar_arrive_expect_tx(full + 8 * s, pv ? kI8Stage : kI8TileK);
        tma_load_3d(kd, &tk8, full + 8 * s, 0, k0, bh);
        if (pv) tma_load_3d(kd + kI8TileK, &tv8, full + 8 * s, k0, 0, bh);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup c: query rows q0 + 64 c .. + 63
  warpgroup_regs_inc<kConsumerRegs>();
  const int c = wg;
  if (c >= active) return;
  const int tid = threadIdx.x % kWarpgroup, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t q8a = base + kI8OffQ8 + c * 64 * kQ8Row;

  // q rows to int8, a warp a row (its own 16): the bf16 row from the
  // 128-byte-swizzled TMA tile, q8 into the 64-byte-swizzled A tile, and
  // qs * scale of rows g and g + 8 kept in registers
  float qsc[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  {
    const uint8_t* qt = smem + c * 64 * kRow;
    uint8_t* q8t = smem + kI8OffQ8 + c * 64 * kQ8Row;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          qt + r * kRow + (((lane >> 2) ^ (r & 7)) << 4) + 4 * (lane & 3)));
      const float sq = __fdiv_rn(fmaxf(warp_max(fmaxf(fabsf(f.x), fabsf(f.y))), 1e-8f), 127.f);
      *reinterpret_cast<uint16_t*>(q8t + r * kQ8Row + (((lane >> 3) ^ ((r >> 1) & 3)) << 4) +
                                   2 * (lane & 7)) = pack_s8x2(quant127(f.x, sq), quant127(f.y, sq));
      if (i == g) qsc[0] = __fmul_rn(sq, scale);
      if (i == g + 8) qsc[1] = __fmul_rn(sq, scale);
    }
  }
  fence_proxy_async();
  named_barrier_sync(1 + c, kWarpgroup);

  // S = Q8 K8^T of ring tile t: 64 rows x kBN keys, two k32 steps. acc[i]
  // is row g + 8 ((i >> 1) & 1) of this warp, key 8 (i >> 2) + 2 tq4 + (i & 1).
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  auto qk = [&](int t) {
    const int s = t % kI8Stages;
    mbar_wait(full + 8 * s, (t / kI8Stages) & 1);
    const uint32_t ka = base + kI8OffKV + s * kI8Stage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk)
      wgmma_m64n128k32_s8(acc, wgmma_desc_sw64(q8a + 32 * kk, 512),
                          wgmma_desc_sw64(ka + 32 * kk, 512), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBN / 2>(acc);
  };
  // s = (float(acc) * (qs * scale)) * ks + bias of accumulators 4 j .. 4 j
  // + 3; |acc| <= 127^2 x 64 < 2^22, so pass 1 (magic) converts on the ALU
  // and pass 2, whose exp2f and p8 keep the conversion unit busy, with I2F
  auto scores = [&](int s, int j, bool magic, float (&sc)[4]) {
    const float2 kj = *reinterpret_cast<const float2*>(kss + s * kBN + 8 * j + 2 * tq4);
    const float2 bj = *reinterpret_cast<const float2*>(bias + s * kBN + 8 * j + 2 * tq4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = magic ? __fsub_rn(__int_as_float(acc[4 * j + e] + kMagicBits), kMagic)
                            : (float)acc[4 * j + e];
      sc[e] = __fadd_rn(__fmul_rn(__fmul_rn(a, qsc[e >> 1]), (e & 1) ? kj.y : kj.x),
                        (e & 1) ? bj.y : bj.x);
    }
  };

  // pass 1: each row's max over all keys
  float mx[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < n_tiles; ++t) {
    qk(t);
    const int s = t % kI8Stages;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float sc[4];
      scores(s, j, true, sc);
      mx[0] = fmaxf(mx[0], fmaxf(sc[0], sc[1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[2], sc[3]));
    }
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // pass 2: p, its f32 row sum, p8 = rint(p * 127) packed straight into the
  // A fragments of O += P8 V8: the 8-key group j of the tile is byte (j & 1)
  // * 2 + (e & 1) of register ((j & 3) >> 1) * 2 + (e >> 1) of 32-key slice
  // j >> 2, which is where v8t's v8_key order puts its keys
  int o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0;
  float rs[2] = {0.f, 0.f};
  for (int t = n_tiles; t < 2 * n_tiles; ++t) {
    qk(t);
    const int s = t % kI8Stages;
    uint32_t pa[kBN / 32][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 32; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = 0u;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float sc[4];
      scores(s, j, false, sc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(__fmul_rn(__fsub_rn(sc[e], mx[e >> 1]), kLog2e));
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
        // rint(p * 127) in 0 .. 127 from the low byte of the magic sum
        const uint32_t byte = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kMagic)) & 0xFFu;
        pa[j >> 2][((j & 3) >> 1) * 2 + (e >> 1)] |= byte << (8 * ((j & 1) * 2 + (e & 1)));
      }
    }
    const uint32_t va = base + kI8OffKV + s * kI8Stage + kI8TileK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 32; ++kk)
      wgmma_m64n64k32_s8_rs(o, pa[kk], wgmma_desc_sw128(va + 32 * kk, 0, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kD / 2>(o);
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
    rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
  }
  // o = (float(acc) * (vs / 127)) / r; o[4 j + 2 r + e] is row g + 8 r,
  // channel 8 j + 2 tq4 + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int ch = 8 * j + 2 * tq4;
      *reinterpret_cast<__nv_bfloat162*>(orow + ch) = __floats2bfloat162_rn(
          __fdiv_rn(__fmul_rn((float)o[4 * j + 2 * r], vsd[ch]), rs[r]),
          __fdiv_rn(__fmul_rn((float)o[4 * j + 2 * r + 1], vsd[ch + 1]), rs[r]));
    }
  }
}

// The 3-D map (cols, rows, slices) of a contiguous int8 tensor: boxes of
// box_cols x box_rows of one slice, zero fill past every edge (past ``rows``
// in particular, so a box never reads the next slice).
bool encode_map_s8_slices(CUtensorMap* map, const void* ptr, int slices, int rows, int cols,
                          int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)cols * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 4-D map (head dim, heads, sequence, batch) of a bf16 (B, L, H, 64) view
// with element strides (sb, sl, sh) and unit stride on the head dim; boxes of
// ``rows`` positions of one head, 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int L, int H, long long sb,
                long long sl, long long sh, int rows) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {kD, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long kernel_launches = 0;   // kernels this library has launched

}  // namespace

// Host microseconds of encoding one call's three tensor maps (the bf16
// entry's arguments), averaged over ``reps``; -1 if an encode fails. The
// maps are encoded at every call; this tells what a cache of them would save.
extern "C" double mars5_mha_encode_us(const void* q, const void* k, const void* v, int B,
                                      int Lq, int Lk, int H, long long sqb, long long sql,
                                      long long sqh, long long skb, long long skl,
                                      long long skh, long long svb, long long svl,
                                      long long svh, int reps) {
  CUtensorMap mq, mk, mv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!encode_map(&mq, q, B, Lq, H, sqb, sql, sqh, kBM) ||
        !encode_map(&mk, k, B, Lk, H, skb, skl, skh, kBN) ||
        !encode_map(&mv, v, B, Lk, H, svb, svl, svh, kBN))
      return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}

extern "C" int mars5_mha_fwd(int is_bf16, const void* q, const void* k,
                             const void* v, const void* mask, void* out, int B,
                             int Lq, int Lk, int H, int D, long long sqb,
                             long long sql, long long sqh, long long skb,
                             long long skl, long long skh, long long svb,
                             long long svl, long long svh, float scale,
                             void* stream) {
  if (D != kD || B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || (long long)B * H > 0x7fffffff ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  if (is_bf16) {
    if ((Lq + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap mq, mk, mv;
    if (!encode_map(&mq, q, B, Lq, H, sqb, sql, sqh, kBM) ||
        !encode_map(&mk, k, B, Lk, H, skb, skl, skh, kBN) ||
        !encode_map(&mv, v, B, Lk, H, svb, svl, svh, kBN))
      return (int)cudaErrorInvalidValue;
    static std::atomic<unsigned> smem_set{0};   // one bit a device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 32 && !(smem_set.load() & (1u << dev))) {
      const cudaError_t err = cudaFuncSetAttribute(
          mha_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      smem_set.fetch_or(1u << dev);
    }
    const dim3 grid(B * H, (Lq + kBM - 1) / kBM);
    mha_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        mq, mk, mv, m, static_cast<__nv_bfloat16*>(out), Lq, Lk, H, scale_log2);
  } else {
    const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh};
    const dim3 grid((Lq + kFRows - 1) / kFRows, H, B);
    mha_fwd_f32_kernel<<<grid, kFRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), m, static_cast<float*>(out), Lq, Lk, H, sq,
        sk, sv, scale_log2);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++kernel_launches;
  return (int)err;
}

// The int8 mode on bf16 views (strides as mars5_mha_fwd's), three launches:
// the two pre-pass kernels and the attention. The scratch parts are the
// caller's (ops/kernels/mha.py int8_plan): k8 (B H, Lk, 64) and v8t (B H, 64,
// Lkp) int8, ks (B H, Lk), vs (B H, 64) and vmax (B H, n_kb, 64) f32, each
// on a 16-byte boundary; Lkp is Lk rounded up to 32, n_kb the 64-key blocks.
extern "C" int mars5_mha_int8_fwd(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, void* k8, void* v8t, void* ks, void* vs, void* vmax,
                                  int B, int Lq, int Lk, int H, int D, long long sqb,
                                  long long sql, long long sqh, long long skb, long long skl,
                                  long long skh, long long svb, long long svl, long long svh,
                                  int Lkp, int n_kb, float scale, void* stream) {
  if (D != kD || B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || (long long)B * H > 65535 ||
      (Lq + kBM - 1) / kBM > 65535 || Lkp % kVBlock != 0 || Lkp < Lk || Lkp - Lk >= kVBlock ||
      n_kb != (Lk + kPreKeys - 1) / kPreKeys)
    return (int)cudaErrorInvalidValue;
  const int bh = B * H;
  CUtensorMap mq, mk8, mv8;
  if (!encode_map(&mq, q, B, Lq, H, sqb, sql, sqh, kBM) ||
      !encode_map_s8_slices(&mk8, k8, bh, Lk, kD, kD, kBN, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_map_s8_slices(&mv8, v8t, bh, kD, Lkp, kBN, kD, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> smem_set{0};   // one bit a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !(smem_set.load() & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kI8Smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) smem_set.fetch_or(1u << dev);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const Strides sv{svb, svl, svh};
  mha_int8_prepass_k<<<dim3(n_kb, bh), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), vb, Lk, H, Strides{skb, skl, skh}, sv,
      static_cast<int8_t*>(k8), static_cast<float*>(ks), static_cast<float*>(vmax), n_kb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++kernel_launches;
  mha_int8_prepass_v<<<dim3((Lkp + kPreKeys - 1) / kPreKeys, bh), 256, 0, st>>>(
      vb, Lk, Lkp, H, sv, static_cast<const float*>(vmax), n_kb, static_cast<float*>(vs),
      static_cast<int8_t*>(v8t));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++kernel_launches;
  mha_int8_kernel<<<dim3(bh, (Lq + kBM - 1) / kBM), kThreads, kI8Smem, st>>>(
      mq, mk8, mv8, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), Lq, Lk, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++kernel_launches;
  return 0;
}

// CUDA kernels this library has launched in this process, both modes.
extern "C" long long mars5_mha_kernel_launches() { return kernel_launches; }
