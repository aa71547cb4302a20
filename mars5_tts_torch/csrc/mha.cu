// Bidirectional multi-head attention forward for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/mha.py::_mha_kernel
// (public entry sdpa_pallas, quantized=False): the NAR decoder's long
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
// product (an online softmax would round other integers). A pre-pass writes
// q8 and k8 (row-major, (B H, L, 64), zero rows past L) with their scales,
// and v8 transposed to (B H, 64, Lk) (K-major for the PV product) with vs,
// in four launches (q rows, k rows, v's channel scales, v8 a 32-key block a
// CTA); the attention is the fifth. A CTA is 64 queries of
// one (batch, head), four warps of 16 rows; both products run on the
// legacy mma.sync m16n8k32 s8 instruction with s32 sums, the operands read
// straight from global memory (each (B H) slice of k8 and v8 is 4.9 KB
// every 64 keys, shared by the CTA's warps through L1). The QK
// accumulators of a 32-key tile become the A fragment of the PV product in
// registers: a thread holds keys {2t, 2t + 1, 8 + 2t, 9 + 2t} (+ 16) of
// its rows where the 8-bit A layout wants keys 4t .. 4t + 3 (+ 16), so the
// pre-pass stores v8's keys in that order inside each 32-key block (a
// reduction's order is free) and no register is moved. The int32 PV sum
// is at most 127^2 Lk, far inside int32 for any NAR length. Not yet tuned:
// wgmma and a shared-memory K/V ring are the next step (ROADMAP B).
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


// ---- int8 mode (see the header): pre-pass, then a two-pass attention
constexpr int kQ8Rows = 64;         // queries a CTA: four warps of 16
constexpr int kKeyTile = 32;        // keys a step: one s8 k32 step of the PV product
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld_s8x4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int quant127(float v, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

// Key order inside a 32-key block of v8: position 4 t + i (+ 16) holds key
// {2t, 2t + 1, 8 + 2t, 9 + 2t}[i] (+ 16), the keys a thread's QK
// accumulators give it.
__device__ __forceinline__ int v8_key(int p) {
  const int r = p & 15, t = r >> 2, i = r & 3;
  return (p & 16) + (i < 2 ? 2 * t + i : 6 + 2 * t + i);
}

// One warp a row of x (B, L, H, 64) bf16 viewed with element strides (sb,
// sl, sh): the row's int8 values at x8 (B H, Lp, 64) and its scale at xs
// (B H, Lp); rows past L get zeros.
__global__ void __launch_bounds__(256)
mha_quant_rows(const __nv_bfloat16* __restrict__ x, int L, int Lp, int H, Strides st,
               int8_t* __restrict__ x8, float* __restrict__ xs, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int l = row % Lp, bh = row / Lp, b = bh / H, h = bh % H;
  auto* dst = reinterpret_cast<uint16_t*>(x8 + (long long)row * kD + 2 * lane);
  if (l >= L) {
    *dst = 0;
    if (lane == 0) xs[row] = 0.f;
    return;
  }
  const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
      x + b * st.b + l * st.l + h * st.h + 2 * lane);
  const float v0 = __low2float(v2), v1 = __high2float(v2);
  const float s = __fdiv_rn(fmaxf(warp_max(fmaxf(fabsf(v0), fabsf(v1))), 1e-8f), 127.f);
  *dst = (uint16_t)((uint8_t)quant127(v0, s) | ((uint32_t)(uint8_t)quant127(v1, s) << 8));
  if (lane == 0) xs[row] = s;
}

// A block a (batch, head): v's per-channel scales over all Lk keys into vs
// (B H, 64).
__global__ void __launch_bounds__(256)
mha_v_scales(const __nv_bfloat16* __restrict__ v, int Lk, int H, Strides st,
             float* __restrict__ vs) {
  __shared__ float red[8][kD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* vb = v + b * st.b + h * st.h;
  float m0 = 0.f, m1 = 0.f;
  for (int key = warp; key < Lk; key += 8) {
    const __nv_bfloat162 v2 =
        *reinterpret_cast<const __nv_bfloat162*>(vb + key * st.l + 2 * lane);
    m0 = fmaxf(m0, fabsf(__low2float(v2)));
    m1 = fmaxf(m1, fabsf(__high2float(v2)));
  }
  red[warp][2 * lane] = m0;
  red[warp][2 * lane + 1] = m1;
  __syncthreads();
  if (threadIdx.x < kD) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    vs[bh * kD + threadIdx.x] = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  }
}

// A block a (32-key block, (batch, head)): those keys of v, int8 at vs's
// scales, into v8 (B H, 64, Lkp), each channel's keys in v8_key order,
// zeros past Lk; the block stages its 32 x 64 tile in shared memory so that
// both the reads and the transposed writes are coalesced.
__global__ void __launch_bounds__(256)
mha_quant_v(const __nv_bfloat16* __restrict__ v, int Lk, int Lkp, int H, Strides st,
            const float* __restrict__ vs, int8_t* __restrict__ v8t) {
  __shared__ float tile[kKeyTile][kD + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * kKeyTile;
  const __nv_bfloat16* vb = v + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kKeyTile * kD / 2; i += 256) {
    const int key = i / (kD / 2), c = 2 * (i % (kD / 2));
    float2 f = make_float2(0.f, 0.f);
    if (k0 + key < Lk)
      f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vb + (k0 + key) * st.l + c));
    tile[key][c] = f.x;
    tile[key][c + 1] = f.y;
  }
  __syncthreads();
  int8_t* dst = v8t + (long long)bh * kD * Lkp + k0;
  for (int i = threadIdx.x; i < kD * kKeyTile / 4; i += 256) {
    const int c = i / (kKeyTile / 4), p0 = (i % (kKeyTile / 4)) * 4;
    const float s = __ldg(vs + bh * kD + c);
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = v8_key(p0 + j);
      const int qv = k0 + key < Lk ? quant127(tile[key][c], s) : 0;
      packed |= (uint32_t)(uint8_t)qv << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(dst + (long long)c * Lkp + p0) = packed;
  }
}

// The attention over the pre-pass's tensors: grid (query tiles of 64, B H),
// 128 threads; warp w takes rows 16 w .. 16 w + 15 of its tile, lane 4 g + t
// rows g and g + 8 (the mma fragments' layout).
__global__ void __launch_bounds__(128)
mha_int8_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
                const int8_t* __restrict__ k8, const float* __restrict__ ks,
                const int8_t* __restrict__ v8t, const float* __restrict__ vs,
                const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, int Lq,
                int Lqp, int Lk, int Lkp, int H, float scale) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kQ8Rows + warp * 16;
  const int8_t* qb = q8 + ((long long)bh * Lqp + r0) * kD;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    qa[kk][0] = ld_s8x4(qb + g * kD + 32 * kk + 4 * t);
    qa[kk][1] = ld_s8x4(qb + (g + 8) * kD + 32 * kk + 4 * t);
    qa[kk][2] = ld_s8x4(qb + g * kD + 32 * kk + 16 + 4 * t);
    qa[kk][3] = ld_s8x4(qb + (g + 8) * kD + 32 * kk + 16 + 4 * t);
  }
  const float qsc[2] = {__fmul_rn(qs[(long long)bh * Lqp + r0 + g], scale),
                        __fmul_rn(qs[(long long)bh * Lqp + r0 + g + 8], scale)};
  const int8_t* kb = k8 + (long long)bh * Lkp * kD;
  const float* ksb = ks + (long long)bh * Lkp;
  const int8_t* vb = v8t + (long long)bh * kD * Lkp;
  const uint8_t* mrow = mask != nullptr ? mask + (long long)b * Lk : nullptr;

  // the scores of keys k0 .. k0 + 31: sc[j][e] is row g + 8 (e >> 1), key
  // k0 + 8 j + 2 t + (e & 1)
  auto scores = [&](int k0, float (&sc)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c[4] = {0, 0, 0, 0};
      const int8_t* kr = kb + (long long)(k0 + 8 * j + g) * kD;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t bf[2] = {ld_s8x4(kr + 32 * kk + 4 * t), ld_s8x4(kr + 32 * kk + 16 + 4 * t)};
        mma_s8_16832(c, qa[kk], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool off = key >= Lk || (mrow != nullptr && mrow[key]);
        sc[j][e] = off ? -INFINITY : __fmul_rn(__fmul_rn((float)c[e], qsc[e >> 1]), ksb[key]);
      }
    }
  };

  // pass 1: the row max over all keys
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Lkp; k0 += kKeyTile) {
    float sc[4][4];
    scores(k0, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }

  // pass 2: p, its sum, p8 and the PV product
  float rsum[2] = {0.f, 0.f};
  int o[8][4];
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c8][e] = 0;
  for (int k0 = 0; k0 < Lkp; k0 += kKeyTile) {
    float sc[4][4];
    scores(k0, sc);
    uint32_t p8[4] = {0u, 0u, 0u, 0u};   // bytes in the v8_key order of this thread's keys
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(__fmul_rn(__fsub_rn(sc[j][e], m[e >> 1]), kLog2e));
        rsum[e >> 1] = __fadd_rn(rsum[e >> 1], p);
        const uint32_t byte = (uint32_t)(uint8_t)__float2int_rn(__fmul_rn(p, 127.f));
        // a0: row g keys j 0-1; a1: row g + 8 keys j 0-1; a2 / a3: j 2-3
        p8[(j >> 1) * 2 + (e >> 1)] |= byte << (8 * ((j & 1) * 2 + (e & 1)));
      }
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int8_t* vr = vb + (long long)(8 * c8 + g) * Lkp + k0;
      const uint32_t bf[2] = {ld_s8x4(vr + 4 * t), ld_s8x4(vr + 16 + 4 * t)};
      mma_s8_16832(o[c8], p8, bf);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(0xffffffffu, rsum[r], 1));
    rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(0xffffffffu, rsum[r], 2));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int ch = 8 * c8 + 2 * t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vsd = __fdiv_rn(vs[bh * kD + ch + e], 127.f);
        y[e] = __fdiv_rn(__fmul_rn((float)o[c8][2 * r + e], vsd), rsum[r]);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + ch) = __floats2bfloat162_rn(y[0], y[1]);
    }
  }
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
  return (int)cudaGetLastError();
}

// Bytes of the int8 mode's scratch at (B, Lq, Lk, H): q8, k8, v8 and their
// scales (row counts padded to 64 queries and 32 keys).
extern "C" long long mars5_mha_int8_scratch_bytes(int B, int Lq, int Lk, int H) {
  const long long bh = (long long)B * H, lqp = (Lq + kQ8Rows - 1) / kQ8Rows * kQ8Rows,
                  lkp = (Lk + kKeyTile - 1) / kKeyTile * kKeyTile;
  return bh * (lqp * kD + 2 * lkp * kD) + 4 * bh * (lqp + lkp + kD);
}

// The int8 mode on bf16 views (strides as mars5_mha_fwd's): five launches.
extern "C" int mars5_mha_int8_fwd(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, void* scratch, int B, int Lq, int Lk, int H, int D,
                                  long long sqb, long long sql, long long sqh, long long skb,
                                  long long skl, long long skh, long long svb, long long svl,
                                  long long svh, float scale, void* stream) {
  if (D != kD || B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || (long long)B * H > 65535 ||
      (Lq + kQ8Rows - 1) / kQ8Rows > 0x7fffffff / 2)
    return (int)cudaErrorInvalidValue;
  const int lqp = (Lq + kQ8Rows - 1) / kQ8Rows * kQ8Rows;
  const int lkp = (Lk + kKeyTile - 1) / kKeyTile * kKeyTile;
  const long long bh = (long long)B * H;
  auto* q8 = static_cast<int8_t*>(scratch);
  int8_t* k8 = q8 + bh * lqp * kD;
  int8_t* v8t = k8 + bh * lkp * kD;
  auto* qs = reinterpret_cast<float*>(v8t + bh * lkp * kD);
  float* ks = qs + bh * lqp;
  float* vs = ks + bh * lkp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const int q_rows = (int)(bh * lqp), k_rows = (int)(bh * lkp);
  mha_quant_rows<<<(q_rows + 7) / 8, 256, 0, st>>>(qb, Lq, lqp, H, Strides{sqb, sql, sqh}, q8,
                                                    qs, q_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_quant_rows<<<(k_rows + 7) / 8, 256, 0, st>>>(kb, Lk, lkp, H, Strides{skb, skl, skh}, k8,
                                                    ks, k_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mha_v_scales<<<(int)bh, 256, 0, st>>>(vb, Lk, H, Strides{svb, svl, svh}, vs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mha_quant_v<<<dim3(lkp / kKeyTile, (unsigned)bh), 256, 0, st>>>(
      vb, Lk, lkp, H, Strides{svb, svl, svh}, vs, v8t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid(lqp / kQ8Rows, (unsigned)bh);
  mha_int8_kernel<<<grid, 128, 0, st>>>(q8, qs, k8, ks, v8t, vs, static_cast<const uint8_t*>(mask),
                                        static_cast<__nv_bfloat16*>(out), Lq, lqp, Lk, lkp, H,
                                        scale);
  return (int)cudaGetLastError();
}
