// Quantized AR decode step for Hopper (sm_90a): kernel K2 fused_decode_layers.
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/decode_layer.py::
// _make_kernel (entry fused_decode_layers): one generated token of each of
// B = 1..8 rows through every layer of the AR backbone, W8A8 (wbits 8) or
// W4A8 (wbits 4, nibble-packed), ring attention over an int8 KV cache, each
// row at its own position.
//
// What bounds it: the weight stream (675 MB a step at W8, 337 MB at W4 at the
// released widths, for any B) plus the int8 K/V of each row's valid slots.
// The products are GEMVs, far below the tensor cores' break-even, so they
// run __dp4a on CUDA cores. The TPU kernel was one program that
// double-buffered weight chunks through VMEM; here a step is ONE cooperative
// launch of a persistent kernel, one block of 256 threads an SM, whose
// phases are parted by grid barriers (a release / acquire counter in the
// caller's memory that leaves itself as it found it). Per layer:
//   wqkv   RMSNorm(h) -> int8 -> wqkv -> q | k | v (f32, scratch)
//   attention, split over the grid by (row, head, slot chunk) units, in three
//          steps (each a grid barrier apart; all three in one block, with no
//          grid barrier, when a (row, head) is one chunk):
//          1. RoPE on q and the new k, per-head q quant, the self score, the
//             int8 scores of the chunk's slots, their max;
//          2. the global max m, p = exp(s - m), the f64 sum of each 64-slot
//             tile, p * vs and its max;
//          3. the global amax of p * vs, the int8 PV product of the chunk,
//             added in int32 (exact, so in any order) to the (row, head) sums
//   wo     the attention output (PV * ps / denom + (p_self / denom) * v) ->
//          int8 -> wo, h += result
//   w13    RMSNorm(h) -> int8 -> w1 and w3 rows of the same u columns,
//          u = silu(w1 x) * w3 x (f32, scratch) and each block's amax of u
//   w2     u -> int8 (its amax from the blocks') -> w2 (both W4 halves summed
//          in int32), h += result
// so 7 grid barriers a layer (5 when a (row, head) is one chunk).
// Each block owns a fixed, contiguous row range of every matrix (the host's
// plan, decode_layer.persistent_plan: taken as given). While it computes phase
// p it bulk-copies (cp.async.bulk, mbarrier completion) its slice of phase
// p + 2 into the buffer phase p frees: weights do not depend on activations,
// so the stream runs on through the barriers and the attention steps. After
// each barrier the block quantizes the B activation rows (read from L2) into
// shared memory once, with the weights already in flight, then its warps walk
// its rows in shared memory, each row dotted with all B activation rows.
// The grid is sized by the host from cudaOccupancyMaxActiveBlocksPerMultiprocessor
// and the SM count; a cooperative launch fails rather than run with blocks
// that are not all resident, and the wrapper raises.
//
// Numerics, those of fused_step_emulation: xs = max(amax, 1e-8) / 127, q =
// rint(x / xs) clipped to +-127 (true division, round half to even); RMSNorm
// x * (1 / sqrt(mean(x * x) + eps)) * w; W8 rescale (acc * xs) * ws, W4
// (ya * sA + yb * sB) * xs, w2 (acc * us) * w2s; scores ((acc * qms) * ks) *
// scale, -inf outside the valid slots; the self score from the unquantized
// f32 q and k; p = exp(s - m), denom = sum + p_self; PV * ps / denom +
// (p_self / denom) * v; silu(a) = a * (1 / (1 + exp(-a))). The three sums
// (RMS, self score, denominator) accumulate in f64 and round to f32 once, as
// the plain twin does; the denominator is summed per 64-slot tile in a fixed
// order and the tiles in slot order, so its f64 value, and every output,
// does not depend on the chunks or the number of rows. Products and sums use
// __fmul_rn / __fadd_rn so no FMA contraction changes a rounding.
//
// The C entry returns the launch's cudaError, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemv_s8.cuh"
#include "hopper.cuh"

namespace {

using namespace mars5;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kMaxBatch = 8;
constexpr int kMaxD = 2048;             // d: 8 columns a thread; wqkv, wo, w13 rows <= 2048 bytes
constexpr int kMaxH = 4096;             // hidden: w2 rows <= 4096 bytes
constexpr int kMaxChunksD = kMaxD / 512;   // 16-byte chunks a lane of a row of d bytes
constexpr int kMaxChunksH = kMaxH / 512;
constexpr int kSlotTile = 64;           // the denominator's f64 tiles (decode_layer.SLOT_TILE)
constexpr int kStaticSmem = 4096;       // the plan's reserve (decode_layer.STATIC_SMEM)
constexpr int kSmemLimit = 232448;

enum Phase { kQkv = 0, kWo = 1, kW13 = 2, kW2 = 3 };

struct Args {
  int wbits, B, L, d, hidden, n_heads, window, w_pad;
  float eps;
  const int* rows;                      // (4, grid + 1) row boundaries of the phases
  int off_norm, off_b, off_act, off_vec, off_x8;   // dynamic shared memory: buffer A at 0
  int chunk, n_chunks;                  // the attention split
  const __nv_bfloat16* x;               // (B, d)
  const int* pos;                       // (B,)
  const float *cos, *sin;               // (B, 32)
  const int8_t *wqkv, *wo, *w13, *w2;
  const float *sqkv, *so, *s13, *s2;
  const float *attn_norms, *ffn_norms;  // (L, d)
  const int8_t *ck, *cv;                // (L, B, w_pad, d)
  const float* kvs;                     // (L, B, 2, w_pad)
  float *h, *k_new, *v_new;             // (B, d), (L, B, d), (L, B, d)
  // scratch (decode_layer.scratch_layout)
  float *qkv, *u, *uamax, *sc, *pmax, *pamax, *selfs, *stats;
  int* pv;
  double* psum;
  unsigned* bar;                        // the grid barrier: count, finish count (128 B apart)
};

struct Shared {
  unsigned long long wbar[2];           // the weight buffers' mbarriers
  unsigned bar_target;                  // thread 0: the count the next grid barrier waits for
  double dred[kWarps][kMaxBatch];       // per-warp f64 sums of each row
  float fred[kWarps][kMaxBatch];
  float xs[kMaxBatch];
  float rs[kMaxBatch];                  // the RMSNorm factors of the B rows
  int rows[4][2];                       // this block's row range of each phase
  unsigned uam[kMaxBatch];              // |u| maxima of this block, as float bits
  float qf[kHeadDim], kf[kHeadDim], vf[kHeadDim];
  __align__(16) int8_t q8[kHeadDim];
  float bc[2];
  int pvacc[kWarps][kHeadDim];
};

// ---- the grid barrier ------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid adds one to the count (a release) and waits (an
// acquire) until all have: barrier k of a launch waits for (k + 1) x grid.
// Every global write before the barrier is visible to every block after it.
// The last block to finish the launch sets the count back to 0
// (finish_grid), so each launch starts from 0 with no host memset. A
// barrier still closed after ~2^34 cycles (~10 s) can only be a fault: the
// kernel traps rather than hold the card.
__device__ void grid_sync(unsigned* count, unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    target += gridDim.x;
    const long long start = clock64();
    while (ld_acquire(count) < target)
      if (clock64() - start > (1ll << 34)) __trap();
  }
  __syncthreads();
}

// The end of a launch: the last block out resets the barrier (count and
// the finish count 32 words on), so the next launch on the stream finds 0.
__device__ void finish_grid(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(count + 32, 1u) == gridDim.x - 1) {
    *count = 0u;
    count[32] = 0u;
  }
}

// ---- block reductions over the B rows (fixed order: the same in every block)

__device__ void block_max_rows(float (&v)[kMaxBatch], int B, Shared& sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kMaxBatch; ++b)
    if (b < B) v[b] = warp_max(v[b]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b)
      if (b < B) sh.fred[warp][b] = v[b];
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kMaxBatch; ++b)
    if (b < B) {
      float r = sh.fred[0][b];
      for (int w = 1; w < kWarps; ++w) r = fmaxf(r, sh.fred[w][b]);
      v[b] = r;
    }
}

// This warp's max of v for batch row b, into sh.fred[warp][b].
__device__ __forceinline__ void warp_row_max(float v, int b, Shared& sh) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) sh.fred[threadIdx.x >> 5][b] = v;
}

// The B rows of act (K floats each, f32, in shared memory) -> x8 (K bytes
// each) with their scales max(amax, 1e-8) / 127 in sh.xs; each warp has left
// its max of each row in sh.fred (warp_row_max).
__device__ void quantize_rows(const float* act, int B, int K, int8_t* x8, Shared& sh) {
  __syncthreads();
  if ((int)threadIdx.x < B) {
    float m = sh.fred[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sh.fred[w][threadIdx.x]);
    sh.xs[threadIdx.x] = row_scale(m);
  }
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    const float sc = sh.xs[b];
    for (int c = threadIdx.x; c < K; c += kThreads)
      x8[b * K + c] = (int8_t)quant127(act[b * K + c], sc);
  }
  __syncthreads();
}

// ---- activation prologues: once a block a phase, after the barrier ---------

// RMSNorm of the B rows of h (of x, bf16, before the first layer): each row
// staged in shared memory (act) as its mean square is summed (f64, a fixed
// order whatever B is), then, once this phase's bulk copy has landed (bar,
// parity: the weights and the norm weight at ``norm``), the normalized rows
// and their maxima, then x8.
__device__ void prologue_rms(const Args& a, bool from_x, float* act, const float* norm,
                             uint32_t bar, uint32_t parity, int8_t* x8, Shared& sh) {
  const int B = a.B, d = a.d, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = 0; b < B; ++b) {
    float* row = act + b * d;
    double ss = 0.0;
    if (from_x) {
      const uint4* x = reinterpret_cast<const uint4*>(a.x + (long long)b * d);
      for (int i = threadIdx.x; i < d / 8; i += kThreads) {
        const uint4 r = __ldg(x + i);
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xffff0000u);
          row[8 * i + 2 * j] = lo;
          row[8 * i + 2 * j + 1] = hi;
          ss += (double)__fmul_rn(lo, lo);
          ss += (double)__fmul_rn(hi, hi);
        }
      }
    } else {
      const float4* h4 = reinterpret_cast<const float4*>(a.h + (long long)b * d);
      float4 v[kMaxD / 4 / kThreads];
#pragma unroll
      for (int j = 0; j < kMaxD / 4 / kThreads; ++j)
        if (threadIdx.x + j * kThreads < d / 4) v[j] = __ldcg(h4 + threadIdx.x + j * kThreads);
#pragma unroll
      for (int j = 0; j < kMaxD / 4 / kThreads; ++j)
        if (threadIdx.x + j * kThreads < d / 4) {
          reinterpret_cast<float4*>(row)[threadIdx.x + j * kThreads] = v[j];
          ss += (double)__fmul_rn(v[j].x, v[j].x);
          ss += (double)__fmul_rn(v[j].y, v[j].y);
          ss += (double)__fmul_rn(v[j].z, v[j].z);
          ss += (double)__fmul_rn(v[j].w, v[j].w);
        }
    }
    ss = warp_sum(ss);
    if (lane == 0) sh.dred[warp][b] = ss;
  }
  __syncthreads();
  if ((int)threadIdx.x < B) {          // r = 1 / sqrt(sum(x * x) / d + eps)
    double t = sh.dred[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) t += sh.dred[w][threadIdx.x];
    const float mean = __fdiv_rn((float)t, (float)d);
    sh.rs[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, a.eps)));
  }
  mbar_wait(bar, parity);
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    const float r = sh.rs[b];
    float am = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float v = __fmul_rn(__fmul_rn(act[b * d + c], r), norm[c]);
      act[b * d + c] = v;
      am = fmaxf(am, fabsf(v));
    }
    warp_row_max(am, b, sh);
  }
  quantize_rows(act, B, d, x8, sh);
}

// The attention output of the B rows, PV * ps / denom + (p_self / denom) * v,
// from the (row, head) values attention step 3 left (stats: ps, p_self,
// denom) and the int32 PV sums, into act, then x8. The stats and a row's PV
// sums and v are loaded together, d <= 8 x 256 columns a row.
__device__ void prologue_attn(const Args& a, float* act, float* vec, int8_t* x8, Shared& sh) {
  const int B = a.B, d = a.d, BH = B * a.n_heads;
  float st[3];                              // 3 x B x H <= 3 x 256
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (threadIdx.x + j * kThreads < 3 * BH) st[j] = __ldcg(a.stats + threadIdx.x + j * kThreads);
  for (int b = 0; b < B; ++b) {
    const int* pv = a.pv + b * d;
    const float* v = a.qkv + (long long)b * 3 * d + 2 * d;
    int pj[kMaxD / kThreads];
    float vj[kMaxD / kThreads];
#pragma unroll
    for (int j = 0; j < kMaxD / kThreads; ++j)
      if (threadIdx.x + j * kThreads < d) {
        pj[j] = __ldcg(pv + threadIdx.x + j * kThreads);
        vj[j] = __ldcg(v + threadIdx.x + j * kThreads);
      }
    if (b == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (threadIdx.x + j * kThreads < 3 * BH) vec[threadIdx.x + j * kThreads] = st[j];
      __syncthreads();
    }
    float am = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxD / kThreads; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c >= d) break;
      const float* sv = vec + 3 * (b * a.n_heads + c / kHeadDim);
      const float ps = sv[0], p_self = sv[1], denom = sv[2];
      const float out = __fmul_rn((float)pj[j], ps);
      const float y = __fadd_rn(__fdiv_rn(out, denom), __fmul_rn(__fdiv_rn(p_self, denom), vj[j]));
      act[b * d + c] = y;
      am = fmaxf(am, fabsf(y));
    }
    warp_row_max(am, b, sh);
  }
  quantize_rows(act, B, d, x8, sh);
}

// u (B, hidden) -> x8 with the amax the w13 blocks left: one pass, the first
// row's values loaded with the amaxes (hidden <= 4 x 4 x 256).
__device__ void prologue_silu(const Args& a, int8_t* x8, Shared& sh) {
  const int B = a.B, K = a.hidden, n4 = K / 4;
  float am[kMaxBatch];
#pragma unroll
  for (int b = 0; b < kMaxBatch; ++b) am[b] = 0.f;
  for (int b = 0; b < B; ++b) {
    const float4* u4 = reinterpret_cast<const float4*>(a.u + (long long)b * K);
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (threadIdx.x + j * kThreads < n4) v[j] = __ldcg(u4 + threadIdx.x + j * kThreads);
    if (b == 0) {
      for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
#pragma unroll
        for (int r = 0; r < kMaxBatch; ++r)
          if (r < B) am[r] = fmaxf(am[r], __ldcg(a.uamax + i * B + r));
      }
      block_max_rows(am, B, sh);
      if (threadIdx.x < B) sh.xs[threadIdx.x] = row_scale(am[threadIdx.x]);
      __syncthreads();
    }
    const float sc = sh.xs[b];
    uint32_t* o = reinterpret_cast<uint32_t*>(x8 + b * K);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (threadIdx.x + j * kThreads < n4)
        o[threadIdx.x + j * kThreads] = (uint32_t)(uint8_t)(int8_t)quant127(v[j].x, sc) |
                                        (uint32_t)(uint8_t)(int8_t)quant127(v[j].y, sc) << 8 |
                                        (uint32_t)(uint8_t)(int8_t)quant127(v[j].z, sc) << 16 |
                                        (uint32_t)(uint8_t)(int8_t)quant127(v[j].w, sc) << 24;
  }
  __syncthreads();
}

// ---- the weight stream ------------------------------------------------------

// One phase's matrix of layer l: rows, bytes a row, and the pack's base.
struct Matrix {
  const int8_t* w;
  const float* s;
  int n, row_bytes;
};

__device__ __forceinline__ Matrix matrix(const Args& a, int l, int k) {
  const int div = a.wbits == 4 ? 2 : 1, g = a.wbits == 4 ? 2 : 1;
  const int rd = a.d / div, rh = a.hidden / div;
  switch (k) {
    case kQkv:
      return {a.wqkv + (long long)l * 3 * a.d * rd, a.sqkv + (long long)l * g * 3 * a.d, 3 * a.d, rd};
    case kWo:
      return {a.wo + (long long)l * a.d * rd, a.so + (long long)l * g * a.d, a.d, rd};
    case kW13:
      return {a.w13 + (long long)l * 2 * a.hidden * rd, a.s13 + (long long)l * g * 2 * a.hidden,
              2 * a.hidden, rd};
    default:
      return {a.w2 + (long long)l * a.d * rh, a.s2 + (long long)l * a.d, a.d, rh};
  }
}

// Thread 0: this block's slice of global phase p (layer p / 4, phase p % 4)
// into its buffer (A for wqkv and w13, B for wo and w2), completing on bar.
__device__ void issue_phase(const Args& a, int p, uint32_t smem, uint32_t bar, const Shared& sh) {
  const int l = p >> 2, k = p & 3;
  const int r0 = sh.rows[k][0], r1 = sh.rows[k][1];
  const Matrix m = matrix(a, l, k);
  const uint32_t dst = smem + (k & 1 ? a.off_b : 0);
  const uint32_t bytes = (uint32_t)(r1 - r0) * m.row_bytes;
  const uint32_t norm = k == kQkv || k == kW13 ? 4 * a.d : 0;   // its RMSNorm weight
  mbar_arrive_expect_tx(bar, (k == kW13 ? 2 * bytes : bytes) + norm);
  if (norm)
    bulk_load(smem + a.off_norm, (k == kQkv ? a.attn_norms : a.ffn_norms) + (long long)l * a.d,
              norm, bar);
  if (bytes == 0) return;
  bulk_load(dst, m.w + (long long)r0 * m.row_bytes, bytes, bar);
  if (k == kW13)                      // the w3 rows of the same u columns
    bulk_load(dst + bytes, m.w + (long long)(a.hidden + r0) * m.row_bytes, bytes, bar);
}

// A weight row in a warp's registers: kN 16-byte chunks a lane at most
// (kN x 512 bytes a row), a chunk a lane at a time.
template <int kN>
struct Row {
  uint4 c[kN];
};

template <int kN>
__device__ __forceinline__ void load_row_smem(Row<kN>& r, const int8_t* row, int n_chunks,
                                              int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (lane + 32 * i < n_chunks) r.c[i] = src[lane + 32 * i];
}

// The row dotted with x8 row xb (shared memory), rescaled: W8 (acc * xs) *
// sa; W4 with a scale a half (ya * sa + yb * sb) * xs, or one a row (ya + yb)
// * xs * sa. half = the row's bytes (K / 2 of x8).
template <bool kW4, bool kSplit, int kN>
__device__ __forceinline__ float dot_row(const Row<kN>& r, const int8_t* xb, int half,
                                         int n_chunks, int lane, float xs, float sa, float sb) {
  const uint4* xl = reinterpret_cast<const uint4*>(xb);
  int ya = 0, yb = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = lane + 32 * i;
    if (idx >= n_chunks) break;
    const uint4 w = r.c[i];
    if (kW4) {
      const uint4 lo = make_uint4(lo_nibbles(w.x), lo_nibbles(w.y), lo_nibbles(w.z), lo_nibbles(w.w));
      const uint4 hi = make_uint4(hi_nibbles(w.x), hi_nibbles(w.y), hi_nibbles(w.z), hi_nibbles(w.w));
      ya = dp4a4(lo, xl[idx], ya);
      yb = dp4a4(hi, reinterpret_cast<const uint4*>(xb + half)[idx], yb);
    } else {
      ya = dp4a4(w, xl[idx], ya);
    }
  }
  if (kW4 && kSplit)
    return __fmul_rn(__fadd_rn(__fmul_rn((float)warp_isum(ya), sa),
                               __fmul_rn((float)warp_isum(yb), sb)), xs);
  return __fmul_rn(__fmul_rn((float)warp_isum(ya + yb), xs), sa);
}

// One GEMV phase of layer l: the prologue, the wait for this block's weights,
// the rows dotted with the B activation rows and the epilogue, the next load
// but one into the freed buffer, and the barrier (none after the last phase).
template <int kPhase, bool kW4>
__device__ void gemv_phase(const Args& a, int l, uint8_t* smem, Shared& sh) {
  const int p = 4 * l + kPhase, B = a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = sh.rows[kPhase][0], r1 = sh.rows[kPhase][1];
  const int nr = r1 - r0;
  const Matrix m = matrix(a, l, kPhase);
  const int K = kPhase == kW2 ? a.hidden : a.d;
  const int n_chunks = m.row_bytes / 16;
  constexpr bool kSplit = kW4 && kPhase != kW2;
  const int sstride = kW4 && kPhase != kW2 ? m.n : 0;   // the second half's scale row

  // this lane's scales (local row warp + 8 lane; w13: its w1 and w3 rows)
  // and this thread's residual value (row t % nr of batch row t / nr), loaded
  // before the prologue so they arrive during it
  float s1a = 0.f, s1b = 0.f, s3a = 0.f, s3b = 0.f, hmine = 0.f;
  const int mine = warp + kWarps * lane;
  if (mine < nr) {
    const int row = r0 + mine;
    s1a = __ldg(m.s + row);
    if (kSplit) s1b = __ldg(m.s + sstride + row);
    if (kPhase == kW13) {
      s3a = __ldg(m.s + a.hidden + row);
      if (kSplit) s3b = __ldg(m.s + sstride + a.hidden + row);
    }
  }
  constexpr bool kResidual = kPhase == kWo || kPhase == kW2;
  if (kResidual && (int)threadIdx.x < nr * B)
    hmine = __ldcg(a.h + (long long)(threadIdx.x / nr) * a.d + r0 + threadIdx.x % nr);

  float* act = reinterpret_cast<float*>(smem + a.off_act);
  float* vec = reinterpret_cast<float*>(smem + a.off_vec);
  const float* norm = reinterpret_cast<const float*>(smem + a.off_norm);
  int8_t* x8 = reinterpret_cast<int8_t*>(smem + a.off_x8);
  const uint32_t bar = smem_addr(&sh.wbar[kPhase & 1]), parity = (p >> 1) & 1;
  if (kPhase == kQkv) prologue_rms(a, l == 0, act, norm, bar, parity, x8, sh);
  if (kPhase == kWo) prologue_attn(a, act, vec, x8, sh);
  if (kPhase == kW13) prologue_rms(a, false, act, norm, bar, parity, x8, sh);
  if (kPhase == kW2) prologue_silu(a, x8, sh);
  mbar_wait(bar, parity);
  const int8_t* wsm = reinterpret_cast<const int8_t*>(smem + (kPhase & 1 ? a.off_b : 0));
  if (kPhase == kW13 && threadIdx.x < kMaxBatch) sh.uam[threadIdx.x] = 0u;
  if (kPhase == kW13) __syncthreads();

  // the rows: one a warp at a time, each held in registers and dotted with
  // the B activation rows in turn (wo, w2: the results into vec, added to h
  // after the loop)
  for (int i = 0, j = warp; j < nr; ++i, j += kWarps) {
    const int row = r0 + j;
    float sa, sb, ta, tb;                  // this row's scales (w13: w1 then w3)
    if (i < 32) {
      sa = __shfl_sync(0xffffffffu, s1a, i);
      sb = __shfl_sync(0xffffffffu, s1b, i);
      ta = __shfl_sync(0xffffffffu, s3a, i);
      tb = __shfl_sync(0xffffffffu, s3b, i);
    } else {
      sa = __ldg(m.s + row);
      sb = kSplit ? __ldg(m.s + sstride + row) : 0.f;
      ta = kPhase == kW13 ? __ldg(m.s + a.hidden + row) : 0.f;
      tb = kPhase == kW13 && kSplit ? __ldg(m.s + sstride + a.hidden + row) : 0.f;
    }
    constexpr int kN = kPhase == kW2 ? kMaxChunksH : kMaxChunksD;
    Row<kN> w1, w3;
    load_row_smem(w1, wsm + (long long)j * m.row_bytes, n_chunks, lane);
    if (kPhase == kW13) load_row_smem(w3, wsm + (long long)(nr + j) * m.row_bytes, n_chunks, lane);
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
      const int8_t* xb = x8 + b * K;
      const float xs = sh.xs[b];
      const float v = dot_row<kW4, kSplit>(w1, xb, m.row_bytes, n_chunks, lane, xs, sa, sb);
      if (kPhase == kQkv) {
        if (lane == 0) a.qkv[(long long)b * 3 * a.d + row] = v;
      } else if (kPhase == kW13) {
        const float g = dot_row<kW4, kSplit>(w3, xb, m.row_bytes, n_chunks, lane, xs, ta, tb);
        if (lane == 0) {
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
          const float u = __fmul_rn(__fmul_rn(v, sig), g);
          a.u[(long long)b * a.hidden + row] = u;
          atomicMax(&sh.uam[b], __float_as_uint(fabsf(u)));
        }
      } else if (lane == 0) {
        vec[b * nr + j] = v;
      }
    }
  }
  if (kResidual) {                         // h += the results
    __syncthreads();
    for (int t = threadIdx.x; t < nr * B; t += kThreads) {
      float* o = a.h + (long long)(t / nr) * a.d + r0 + t % nr;
      *o = __fadd_rn(t == (int)threadIdx.x ? hmine : __ldcg(o), vec[t]);
    }
  }
  if (kPhase == kW13) {                    // this block's amax of u, per row
    __syncthreads();
    if (threadIdx.x < B)
      a.uamax[blockIdx.x * B + threadIdx.x] = __uint_as_float(sh.uam[threadIdx.x]);
  }
  __syncthreads();                         // every warp is done with the buffer
  if (threadIdx.x == 0 && p + 2 < 4 * a.L) issue_phase(a, p + 2, smem_addr(smem), bar, sh);
  if (p + 1 < 4 * a.L) grid_sync(a.bar, sh.bar_target);
}

// ---- attention ---------------------------------------------------------------

// rope of column c (0..63) of one head: x * cos + (+-pair) * sin
__device__ __forceinline__ float rope64(const float* x, int c, const float* cos,
                                        const float* sin) {
  const int i = c & 31;
  const float pr = c < 32 ? -__ldcg(x + c + 32) : __ldcg(x + c - 32);
  return __fadd_rn(__fmul_rn(__ldcg(x + c), __ldg(cos + i)), __fmul_rn(pr, __ldg(sin + i)));
}

// A unit u = ((b * H) + head) * n_chunks + chunk: its row's view of layer l.
struct Unit {
  int b, hd, bh, c, pos, n, cur, s_lo, s_hi, base;
  const int8_t *ck, *cv;
  const float *ks, *vs;
  float* sc;
};

__device__ __forceinline__ Unit unit_of(const Args& a, int l, int u) {
  Unit t;
  t.c = u % a.n_chunks;
  t.bh = u / a.n_chunks;
  t.hd = t.bh % a.n_heads;
  t.b = t.bh / a.n_heads;
  t.pos = __ldg(a.pos + t.b);
  t.n = min(t.pos + 1, a.window);
  t.cur = t.pos % a.window;
  t.s_lo = t.c * a.chunk;
  t.s_hi = min(t.s_lo + a.chunk, t.n);
  t.base = t.hd * kHeadDim;
  const long long lb = (long long)l * a.B + t.b;
  t.ck = a.ck + lb * a.w_pad * a.d;
  t.cv = a.cv + lb * a.w_pad * a.d;
  t.ks = a.kvs + lb * 2 * a.w_pad;
  t.vs = t.ks + a.w_pad;
  t.sc = a.sc + (long long)t.bh * a.w_pad;
  return t;
}

// The max of ``init`` and the n per-chunk values at p, each lane loading one
// (n_chunks <= 32, decode_layer.attention_split); every lane gets it.
__device__ __forceinline__ float chunk_max(const float* p, int n, float init, int lane) {
  return warp_max(fmaxf(init, lane < n ? __ldcg(p + lane) : init));
}

// Step 1: RoPE, q quant, the self score (chunk 0), the chunk's scores and their max.
__device__ void attn_scores(const Args& a, int l, int u, Shared& sh) {
  const Unit t = unit_of(a, l, u);
  const int tid = threadIdx.x, d = a.d;
  if (tid < kHeadDim) {
    const float* qkv = a.qkv + (long long)t.b * 3 * d;
    const float* cs = a.cos + t.b * 32;
    const float* sn = a.sin + t.b * 32;
    sh.qf[tid] = rope64(qkv + t.base, tid, cs, sn);
    sh.kf[tid] = rope64(qkv + d + t.base, tid, cs, sn);
    sh.vf[tid] = __ldcg(qkv + 2 * d + t.base + tid);
    if (t.c == 0) {
      const long long o = ((long long)l * a.B + t.b) * d + t.base + tid;
      a.k_new[o] = sh.kf[tid];
      a.v_new[o] = sh.vf[tid];
      a.pv[t.b * d + t.base + tid] = 0;
    }
  }
  __syncthreads();
  const float scale = 1.f / sqrtf((float)kHeadDim);
  if (tid < 32) {  // per-head q quant and the self score
    const float qms = row_scale(warp_max(fmaxf(fabsf(sh.qf[tid]), fabsf(sh.qf[tid + 32]))));
    sh.q8[tid] = (int8_t)quant127(sh.qf[tid], qms);
    sh.q8[tid + 32] = (int8_t)quant127(sh.qf[tid + 32], qms);
    if (tid == 0) {
      sh.bc[0] = qms;
      if (t.c == 0) {
        double s = 0.0;
        for (int c = 0; c < kHeadDim; ++c) s += (double)__fmul_rn(sh.qf[c], sh.kf[c]);
        a.selfs[t.bh] = __fmul_rn((float)s, scale);
      }
    }
  }
  __syncthreads();
  const float qms = sh.bc[0];
  int qw[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) qw[j] = reinterpret_cast<const int*>(sh.q8)[j];
  float mloc = -INFINITY;
  for (int s0 = t.s_lo + tid; s0 < t.s_hi; s0 += 2 * kThreads) {
    uint4 kv[2][4];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int s = s0 + v * kThreads;
      if (s < t.s_hi) {
        const uint4* kr = reinterpret_cast<const uint4*>(t.ck + (long long)s * d + t.base);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[v][j] = __ldg(kr + j);
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int s = s0 + v * kThreads;
      if (s < t.s_hi) {
        float sv = -INFINITY;
        if (s != t.cur) {
          int acc = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc = dp4a4(kv[v][j], make_uint4(qw[4 * j], qw[4 * j + 1], qw[4 * j + 2], qw[4 * j + 3]),
                        acc);
          sv = __fmul_rn(__fmul_rn(__fmul_rn((float)acc, qms), __ldg(t.ks + s)), scale);
        }
        t.sc[s] = sv;
        mloc = fmaxf(mloc, sv);
      }
    }
  }
  const float m = block_max<kWarps>(mloc, &sh.fred[0][0]);
  if (tid == 0) a.pmax[u] = m;
}

// Step 2: the global max, p = exp(s - m) and the f64 sum of each 64-slot
// tile (one warp a tile, a fixed order), p * vs into the scores and its max.
__device__ void attn_softmax(const Args& a, int l, int u, Shared& sh) {
  const Unit t = unit_of(a, l, u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, NC = a.n_chunks;
  const int tiles = (a.window + kSlotTile - 1) / kSlotTile;
  const float m = chunk_max(a.pmax + t.bh * NC, NC, __ldcg(a.selfs + t.bh), lane);
  float am = 0.f;
  const int t1 = (t.s_hi + kSlotTile - 1) / kSlotTile;
  for (int ti = t.s_lo / kSlotTile + warp; ti < t1; ti += kWarps) {
    float sv[2], vsv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {           // both slots' loads before either is used
      const int s = ti * kSlotTile + 32 * j + lane;
      sv[j] = s < t.s_hi ? __ldcg(t.sc + s) : 0.f;
      vsv[j] = s < t.s_hi ? __ldg(t.vs + s) : 0.f;
    }
    double part = 0.0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = ti * kSlotTile + 32 * j + lane;
      float e = 0.f;
      if (s < t.s_hi) {
        float pvs = 0.f;
        if (s != t.cur) {
          e = expf(__fsub_rn(sv[j], m));
          pvs = __fmul_rn(e, vsv[j]);
        }
        t.sc[s] = pvs;
        am = fmaxf(am, fabsf(pvs));
      }
      part += (double)e;
    }
    part = warp_sum(part);
    if (lane == 0) a.psum[(long long)t.bh * tiles + ti] = part;
  }
  am = block_max<kWarps>(am, &sh.fred[0][0]);
  if (threadIdx.x == 0) a.pamax[u] = am;
}

// Step 3: the global amax of p * vs, the chunk's int8 PV product (4 lanes a
// slot, 16 columns a lane), added to the (row, head) sums in int32.
__device__ void attn_pv(const Args& a, int l, int u, Shared& sh) {
  const Unit t = unit_of(a, l, u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, NC = a.n_chunks;
  const float ps = row_scale(chunk_max(a.pamax + t.bh * NC, NC, 0.f, lane));
  if (t.c == 0 && warp == 0) {              // the (row, head)'s ps, p_self and denominator
    const float self_s = __ldcg(a.selfs + t.bh);
    const float m = chunk_max(a.pmax + t.bh * NC, NC, self_s, lane);
    const int tiles = (a.window + kSlotTile - 1) / kSlotTile;
    double sum = 0.0;                       // lane l: tiles l, l + 32, ...; then a fixed tree
    for (int ti = lane; ti < (t.n + kSlotTile - 1) / kSlotTile; ti += 32)
      sum += __ldcg(a.psum + (long long)t.bh * tiles + ti);
    sum = warp_sum(sum);
    if (lane == 0) {
      const float p_self = expf(__fsub_rn(self_s, m));
      a.stats[3 * t.bh] = ps;
      a.stats[3 * t.bh + 1] = p_self;
      a.stats[3 * t.bh + 2] = __fadd_rn((float)sum, p_self);
    }
  }
  if (t.s_lo >= t.s_hi) return;             // uniform across the block
  const int cg = tid & 3, groups = kThreads / 4;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int s0 = t.s_lo + (tid >> 2); s0 < t.s_hi; s0 += 2 * groups) {
    uint4 vv[2];
    int w[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int s = s0 + v * groups;
      w[v] = s < t.s_hi ? quant127(__ldcg(t.sc + s), ps) : 0;
      if (w[v] != 0)
        vv[v] = __ldg(reinterpret_cast<const uint4*>(t.cv + (long long)s * a.d + t.base + 16 * cg));
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (w[v] == 0) continue;
      const uint32_t words[4] = {vv[v].x, vv[v].y, vv[v].z, vv[v].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += w[v] * (int)(int8_t)(words[j >> 2] >> (8 * (j & 3)));
    }
  }
  // sum the 8 slot groups of each warp (lanes with the same tid % 4), then the warps
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) sh.pvacc[warp][16 * lane + j] = acc[j];
  }
  __syncthreads();
  if (tid < kHeadDim) {
    int tot = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) tot += sh.pvacc[i][tid];
    atomicAdd(a.pv + t.b * a.d + t.base + tid, tot);
  }
  __syncthreads();
}

__device__ void attention(const Args& a, int l, Shared& sh) {
  const int units = a.B * a.n_heads * a.n_chunks;
  if (a.n_chunks == 1) {                    // a (row, head) in one block
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      attn_scores(a, l, u, sh);
      __syncthreads();
      attn_softmax(a, l, u, sh);
      __syncthreads();
      attn_pv(a, l, u, sh);
    }
    grid_sync(a.bar, sh.bar_target);
    return;
  }
  for (int u = blockIdx.x; u < units; u += gridDim.x) attn_scores(a, l, u, sh);
  grid_sync(a.bar, sh.bar_target);
  for (int u = blockIdx.x; u < units; u += gridDim.x) attn_softmax(a, l, u, sh);
  grid_sync(a.bar, sh.bar_target);
  for (int u = blockIdx.x; u < units; u += gridDim.x) attn_pv(a, l, u, sh);
  grid_sync(a.bar, sh.bar_target);
}

template <bool kW4>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_step(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ Shared sh;
  const uint32_t base = smem_addr(smem);
  if (threadIdx.x < 8)                      // this block's row ranges
    sh.rows[threadIdx.x >> 1][threadIdx.x & 1] =
        __ldg(a.rows + (threadIdx.x >> 1) * (gridDim.x + 1) + blockIdx.x + (threadIdx.x & 1));
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&sh.wbar[0]), 1);
    mbar_init(smem_addr(&sh.wbar[1]), 1);
    mbar_init_fence();
    sh.bar_target = 0u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {                   // the first two phases' weights
    issue_phase(a, 0, base, smem_addr(&sh.wbar[0]), sh);
    issue_phase(a, 1, base, smem_addr(&sh.wbar[1]), sh);
  }
  // the embedded rows into h (read first by the wo phase, after two barriers)
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.B * a.d; i += gridDim.x * kThreads)
    a.h[i] = __bfloat162float(a.x[i]);
  for (int l = 0; l < a.L; ++l) {
    gemv_phase<kQkv, kW4>(a, l, smem, sh);
    attention(a, l, sh);
    gemv_phase<kWo, kW4>(a, l, smem, sh);
    gemv_phase<kW13, kW4>(a, l, smem, sh);
    gemv_phase<kW2, kW4>(a, l, smem, sh);
  }
  finish_grid(a.bar);
}

long long kernel_launches = 0;          // kernels this library has launched

bool configure(int smem) {
  static int configured = 0;
  if (configured >= smem) return true;
  const int most = kSmemLimit - kStaticSmem;
  if (smem > most) return false;
  if (cudaFuncSetAttribute(fused_decode_step<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most) != cudaSuccess ||
      cudaFuncSetAttribute(fused_decode_step<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most) != cudaSuccess)
    return false;
  configured = most;
  return true;
}

}  // namespace

// Blocks of ``smem`` bytes of dynamic shared memory that fit one SM at once
// (the smaller of the W8 and W4 kernels').
extern "C" int mars5_fused_decode_occupancy(int smem, int* blocks_per_sm) {
  *blocks_per_sm = 0;
  if (!configure(smem)) return (int)cudaErrorInvalidValue;
  int n8 = 0, n4 = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n8, fused_decode_step<false>,
                                                                kThreads, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n4, fused_decode_step<true>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  *blocks_per_sm = n8 < n4 ? n8 : n4;
  return 0;
}

extern "C" int mars5_fused_decode(int wbits, int B, int L, int d, int hidden, int n_heads,
                                  int window, int w_pad, float eps, int grid, const void* rows,
                                  int off_norm, int off_b, int off_act, int off_vec, int off_x8,
                                  int smem, int chunk, int n_chunks, const void* x,
                                  const void* pos, const void* cos, const void* sin,
                                  const void* wqkv, const void* sqkv, const void* wo,
                                  const void* so, const void* w13, const void* s13,
                                  const void* w2, const void* s2, const void* attn_norms,
                                  const void* ffn_norms, const void* cache_k, const void* cache_v,
                                  const void* kv_scales, void* h, void* k_new, void* v_new,
                                  void* scratch, const long long* offsets,
                                  long long scratch_bytes, void* barrier,
                                  void* stream) {
  const int div = wbits == 4 ? 2 : 1;
  if ((wbits != 8 && wbits != 4) || B < 1 || B > kMaxBatch || L <= 0 ||
      d != n_heads * kHeadDim || window <= 0 || w_pad < window || (d / div) % 16 ||
      (hidden / div) % 16 || d > kMaxD || hidden > kMaxH ||
      hidden % 4 || grid < 1 || off_norm % 16 || off_b - off_norm < 4 * d || off_b % 16 ||
      off_act % 16 || off_vec % 16 || off_x8 % 16 || off_vec - off_act < 4 * B * d ||
      off_x8 - off_vec < 4 * d || off_x8 + B * (d > hidden ? d : hidden) > smem ||
      chunk < kSlotTile || chunk % kSlotTile || n_chunks < 1 || n_chunks > 32 ||
      !configure(smem))
    return (int)cudaErrorInvalidValue;
  // the scratch regions' byte offsets, decode_layer.scratch_layout's
  for (int i = 0; i < 10; ++i)
    if (offsets[i] % 16 || (i && offsets[i] < offsets[i - 1]) || offsets[i] >= scratch_bytes)
      return (int)cudaErrorInvalidValue;
  const long long* off = offsets;
  char* s = static_cast<char*>(scratch);
  Args a{wbits, B, L, d, hidden, n_heads, window, w_pad, eps,
         static_cast<const int*>(rows), off_norm, off_b, off_act, off_vec, off_x8, chunk,
         n_chunks,
         static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(pos),
         static_cast<const float*>(cos), static_cast<const float*>(sin),
         static_cast<const int8_t*>(wqkv), static_cast<const int8_t*>(wo),
         static_cast<const int8_t*>(w13), static_cast<const int8_t*>(w2),
         static_cast<const float*>(sqkv), static_cast<const float*>(so),
         static_cast<const float*>(s13), static_cast<const float*>(s2),
         static_cast<const float*>(attn_norms), static_cast<const float*>(ffn_norms),
         static_cast<const int8_t*>(cache_k), static_cast<const int8_t*>(cache_v),
         static_cast<const float*>(kv_scales), static_cast<float*>(h),
         static_cast<float*>(k_new), static_cast<float*>(v_new),
         reinterpret_cast<float*>(s + off[0]), reinterpret_cast<float*>(s + off[1]),
         reinterpret_cast<float*>(s + off[2]), reinterpret_cast<float*>(s + off[3]),
         reinterpret_cast<float*>(s + off[4]), reinterpret_cast<float*>(s + off[5]),
         reinterpret_cast<float*>(s + off[6]), reinterpret_cast<float*>(s + off[7]),
         reinterpret_cast<int*>(s + off[8]), reinterpret_cast<double*>(s + off[9]),
         static_cast<unsigned*>(barrier)};
  void* params[] = {&a};
  const void* fn = wbits == 4 ? reinterpret_cast<const void*>(fused_decode_step<true>)
                              : reinterpret_cast<const void*>(fused_decode_step<false>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params,
                                                    (size_t)smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    // a refused launch also leaves its error as the last one, which the next
    // call's cudaGetLastError would report: clear it
    cudaGetLastError();
    return (int)e;
  }
  ++kernel_launches;
  return (int)cudaGetLastError();
}

// Kernels launched by this library so far (one a decode step).
extern "C" long long mars5_fused_decode_kernel_launches() { return kernel_launches; }
