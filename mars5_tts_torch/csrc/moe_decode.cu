// The routed-expert SwiGLU of one decode step for Hopper (sm_90a): kernel
// K10 moe_decode (ops/kernels/moe_decode.py holds its plain twin).
//
// For rows b of x (B, D), B in 1-8, each with k expert ids and weights (the
// router's top k, read from device memory: no host sync a layer):
//
//   y_b = sum_k p_bk W2_e (silu(W1_e x_b) * W3_e x_b) + S(x_b),  e = ids[b, k]
//
// each expert's W1 over its W3 in w13 (E, 2F, D), its W2 in w2 (E, D, F); S
// the shared experts' SwiGLU (w1s, w3s (Fs, D), w2s (D, Fs)), run as one more
// expert that every row takes with weight 1.
//
// What bounds it: bytes. One row of DeepSeek-V2-Lite reads 6 routed experts
// and the shared pair, 138.4 MB a layer (3 x 2048 x 1408 x 2 B each), 41.3 us
// at the H100 SXM's data-sheet 3.35 TB/s, against 69 M multiply-adds. Eight
// rows read each distinct expert once (about 35 of 64 under random routing).
//
// The design: two launches. Every block first builds the step's routing
// table from ids alike (warp 0: the experts present as a 64-bit mask, the
// distinct ones in ascending order, each with the mask of rows that chose
// it). (1) moe_decode_up: a warp per (expert, inner channel f); the
// blockIdx.y-th distinct expert (the last y the shared one), blocks of an
// expert no row chose exit; each lane streams 8 16-byte chunks of the W1 row
// and 8 of the W3 row, all loaded before any is used, against the rows' x in
// shared memory; h = silu(a) * b per (expert, row) into an f32 scratch. (2)
// moe_decode_down: a warp per output channel d walks the distinct experts,
// 6 16-byte chunks of the W2 row in flight a lane, each row's dot over h;
// then lane b sums row b's slots in the row's k order, the shared expert
// last, and rounds to bf16 once. A weight row is read once for all the rows
// that chose its expert. (A block per (channel tile, expert), the tile's
// last block summing the slots behind a counter, took 85.7 us a call at one
// row against this design's 73.5, on an H100: its blocks are too short for
// the table each builds.)
//
// Numerics: every dot product adds exact products (bf16 x bf16 in f32, bf16
// x f32 in f64) in f64 and rounds to f32 once, as the twin's f64 matmuls do;
// then the same f32 ops as the twin: silu(a) = a / (1 + expf(-a)), h =
// silu(a) * b, acc = acc + p * y a slot (no fused multiply-add), + S, one
// rounding to bf16. Kernel and twin agree bit for bit except where an f64
// sum taken in another order lands across an f32 rounding boundary.
//
// The C entry launches both kernels on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kMaxK = 8;
constexpr int kMaxExperts = 64;                    // the table's mask
constexpr int kMaxDim = 2048;                      // x's rows in shared memory
constexpr int kVec = 8;                            // bf16 a 16-byte load
constexpr int kUpChunks = kMaxDim / (32 * kVec);   // chunks a lane takes of a D-long row
constexpr int kDownUnroll = 6;                     // W2 chunks a lane loads at once
constexpr int kMaxUnits = kMaxRows * kMaxK + 1;    // distinct routed experts, then the shared

struct Args {
  const __nv_bfloat16* x;    // (B, D)
  const int* ids;            // (B, K)
  const float* w;            // (B, K)
  const __nv_bfloat16* w13;  // (E, 2F, D)
  const __nv_bfloat16* w2;   // (E, D, F)
  const __nv_bfloat16* s1;   // (Fs, D), or null with s3, s2
  const __nv_bfloat16* s3;   // (Fs, D)
  const __nv_bfloat16* s2;   // (D, Fs)
  float* h;                  // (B K + 1, B, fmax) scratch
  __nv_bfloat16* out;        // (B, D)
  int* load;                 // (E,) routed slots tallied, or null
  int B, K, E, D, F, Fs, fmax;
};

struct Table {
  unsigned long long present;  // bit e: some row chose expert e
  int n;                       // distinct routed experts
  int expert[kMaxUnits];       // ascending
  int rows[kMaxUnits];         // bit b: row b chose it
};

__device__ __forceinline__ uint4 ld_stream(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// An expert's place among the distinct ones: the experts present below it.
__device__ __forceinline__ int unit_of(unsigned long long present, int e) {
  return __popcll(present & ((1ull << e) - 1ull));
}

__device__ __forceinline__ bool valid_id(int e, int E) { return e >= 0 && e < E; }

// Every block builds the same table; ends with __syncthreads.
__device__ void build_table(const Args& a, Table& t) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, n = a.B * a.K;
    unsigned long long bits = 0;
    for (int i = lane; i < n; i += 32) {
      const int e = a.ids[i];
      if (valid_id(e, a.E)) bits |= 1ull << e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, o);
    for (int e = lane; e < kMaxExperts; e += 32)
      if ((bits >> e) & 1ull) {
        const int u = unit_of(bits, e);
        t.expert[u] = e;
        t.rows[u] = 0;
      }
    if (lane == 0) {
      t.present = bits;
      t.n = __popcll(bits);
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const int e = a.ids[i];
      if (valid_id(e, a.E)) atomicOr(&t.rows[unit_of(bits, e)], 1 << (i / a.K));
    }
  }
  __syncthreads();
}

// acc += the 8 exact products of a weight chunk and an x chunk (bf16 each).
__device__ __forceinline__ void dot8(const uint4 w, const uint4 x, double& acc) {
  const uint32_t wv[4] = {w.x, w.y, w.z, w.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc += (double)__fmul_rn(bf_lo(wv[j]), bf_lo(xv[j]));
    acc += (double)__fmul_rn(bf_hi(wv[j]), bf_hi(xv[j]));
  }
}

__global__ void __launch_bounds__(kThreads) moe_decode_up(const Args a) {
  const bool shared_unit = a.s1 != nullptr && blockIdx.y == gridDim.y - 1;
  const int F = shared_unit ? a.Fs : a.F;
  const int f0 = blockIdx.x * kWarps;
  if (f0 >= F) return;  // past this unit's channels
  __shared__ __align__(16) __nv_bfloat16 xs[kMaxRows * kMaxDim];
  __shared__ Table t;
  const int nvec = a.B * a.D / kVec;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    reinterpret_cast<uint4*>(xs)[i] = reinterpret_cast<const uint4*>(a.x)[i];
  build_table(a, t);
  if (blockIdx.x == 0 && blockIdx.y == 0 && a.load != nullptr && threadIdx.x < a.B * a.K) {
    const int e = a.ids[threadIdx.x];
    if (valid_id(e, a.E)) atomicAdd(a.load + e, 1);
  }
  const int u = blockIdx.y;
  if (!shared_unit && u >= t.n) return;  // no row chose a u-th expert
  const int rows = shared_unit ? (1 << a.B) - 1 : t.rows[u];
  const int slot = shared_unit ? a.B * a.K : u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = f0 + warp;
  if (f >= F) return;
  const __nv_bfloat16* r1 = shared_unit
      ? a.s1 + (size_t)f * a.D
      : a.w13 + ((size_t)t.expert[u] * 2 * F + f) * a.D;
  const __nv_bfloat16* r3 = shared_unit ? a.s3 + (size_t)f * a.D : r1 + (size_t)F * a.D;
  const int nch = a.D / (32 * kVec);
  uint4 v1[kUpChunks], v3[kUpChunks];
#pragma unroll
  for (int i = 0; i < kUpChunks; ++i)
    if (i < nch) {
      v1[i] = ld_stream(r1 + (i * 32 + lane) * kVec);
      v3[i] = ld_stream(r3 + (i * 32 + lane) * kVec);
    }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (!((rows >> r) & 1)) continue;
    const __nv_bfloat16* xr = xs + r * a.D;
    double g = 0.0, up = 0.0;
#pragma unroll
    for (int i = 0; i < kUpChunks; ++i)
      if (i < nch) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xr + (i * 32 + lane) * kVec);
        dot8(v1[i], xv, g);
        dot8(v3[i], xv, up);
      }
    g = warp_sum(g);
    up = warp_sum(up);
    if (lane == 0) {
      const float gf = (float)g;
      a.h[((size_t)slot * a.B + r) * a.fmax + f] = gf / (1.0f + expf(-gf)) * (float)up;
    }
  }
}

__global__ void __launch_bounds__(kThreads) moe_decode_down(const Args a) {
  __shared__ Table t;
  __shared__ float ys[kWarps][kMaxUnits][kMaxRows];
  build_table(a, t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarps + warp;
  const bool has_shared = a.s1 != nullptr;
  const int units = t.n + (has_shared ? 1 : 0);
  for (int j = 0; j < units; ++j) {
    const bool sh = j == t.n;
    const int F = sh ? a.Fs : a.F;
    const int rows = sh ? (1 << a.B) - 1 : t.rows[j];
    const int slot = sh ? a.B * a.K : j;
    const __nv_bfloat16* wr = sh ? a.s2 + (size_t)d * F
                                 : a.w2 + ((size_t)t.expert[j] * a.D + d) * F;
    double acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0;
    const int nch = F / kVec;
    for (int base = 0; base < nch; base += 32 * kDownUnroll) {
      uint4 v[kDownUnroll];
#pragma unroll
      for (int i = 0; i < kDownUnroll; ++i) {
        const int c = base + i * 32 + lane;
        if (c < nch) v[i] = ld_stream(wr + c * kVec);
      }
#pragma unroll
      for (int i = 0; i < kDownUnroll; ++i) {
        const int c = base + i * 32 + lane;
        if (c >= nch) continue;
        const uint32_t wv[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        double wd[kVec];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wd[2 * q] = (double)bf_lo(wv[q]);
          wd[2 * q + 1] = (double)bf_hi(wv[q]);
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (!((rows >> r) & 1)) continue;
          const float4* hp =
              reinterpret_cast<const float4*>(a.h + ((size_t)slot * a.B + r) * a.fmax + c * kVec);
          const float4 h0 = hp[0], h1 = hp[1];
          const float hv[kVec] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int q = 0; q < kVec; ++q) acc[r] = fma(wd[q], (double)hv[q], acc[r]);
        }
      }
    }
    const int sj = sh ? kMaxUnits - 1 : j;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (!((rows >> r) & 1)) continue;
      const double sum = warp_sum(acc[r]);
      if (lane == 0) ys[warp][sj][r] = (float)sum;
    }
  }
  __syncwarp();
  if (lane < a.B) {
    const int r = lane;
    float total = 0.0f;
    for (int k = 0; k < a.K; ++k) {
      const int e = a.ids[r * a.K + k];
      if (!valid_id(e, a.E)) continue;
      total = __fadd_rn(total, __fmul_rn(a.w[r * a.K + k], ys[warp][unit_of(t.present, e)][r]));
    }
    if (has_shared) total = __fadd_rn(total, ys[warp][kMaxUnits - 1][r]);
    a.out[(size_t)r * a.D + d] = __float2bfloat16_rn(total);
  }
}

}  // namespace

extern "C" int mars5_moe_decode(const void* x, const void* ids, const void* w, const void* w13,
                                const void* w2, const void* s1, const void* s3, const void* s2,
                                void* h, void* out, void* load, int B, int K, int E, int D,
                                int F, int Fs, void* stream) {
  const bool shared = s1 != nullptr;
  if (B < 1 || B > kMaxRows || K < 1 || K > kMaxK || E < 1 || E > kMaxExperts || D <= 0 ||
      D > kMaxDim || D % (32 * kVec) || F <= 0 || F % kVec ||
      (shared && (Fs <= 0 || Fs % kVec)) || shared != (s3 != nullptr) ||
      shared != (s2 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int fmax = shared && Fs > F ? Fs : F;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(ids),
               static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(w13),
               static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(s1),
               static_cast<const __nv_bfloat16*>(s3), static_cast<const __nv_bfloat16*>(s2),
               static_cast<float*>(h), static_cast<__nv_bfloat16*>(out),
               static_cast<int*>(load), B, K, E, D, F, shared ? Fs : 0, fmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 up((fmax + kWarps - 1) / kWarps, B * K + (shared ? 1 : 0));
  moe_decode_up<<<up, kThreads, 0, st>>>(a);
  moe_decode_down<<<D / kWarps, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
