// Bidirectional multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mars5_tts_tpu/ops/pallas/mha.py::_mha_kernel
// (public entry sdpa_pallas, quantized=False): the NAR decoder's long
// self-attention and the speaker encoders' self-attention once the sequence
// reaches 512 frames.
//
//   q (B, Lq, H, D), k/v (B, Lk, H, D), bf16 or f32, any row strides with a
//   unit stride on D; optional key-padding mask (B, Lk) uint8, nonzero =
//   ignore. Output (B, Lq, H, D) contiguous, in q's dtype.
//   scores and softmax in f32: s = q.k, p = exp2((s - max s) * scale*log2e),
//   o = (p @ v) / sum(p), with p rounded to the input dtype before the PV
//   product (as the Pallas kernel does) and the row sum taken in f32.
//
// What bounds it here: at the NAR shape (2, 1200, 16, 64) one call reads and
// writes ~20 MB and does ~11.8 GFLOP, ~600 FLOP per byte, so it is bound by
// the matrix units, not by memory. The TPU kernel held a whole row of keys in
// VMEM; a Hopper block cannot, so this one walks the keys in 64-wide tiles
// staged in shared memory with an online (running max / running sum) softmax,
// keeps the 64x64 output tile in f32 registers and normalizes once at the end.
// The scores never reach device memory. The bf16 kernel runs mma.sync
// m16n8k16 (bf16 in, f32 accumulate); the f32 kernel uses CUDA-core FMAs.
// No wgmma, TMA or load pipelining yet.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace mars5;

constexpr int kD = 64;         // head dim supported
constexpr int kBM = 64;         // query rows per block (16 per warp)
constexpr int kBN = 64;         // keys per shared-memory tile
constexpr int kLds = kD + 8;    // padded smem row (bf16): conflict-free fragment reads
constexpr int kThreads = 128;

struct Strides {
  long long b, l, h;            // element strides of the batch, sequence, head axes
};

// One block = (64 query rows, one head, one batch row); 4 warps, 16 rows each.
// Fragment layouts follow the PTX m16n8k16 tables: lane = 4*g + t holds
// A rows {g, g+8} x cols {2t, 2t+1, 2t+8, 2t+9}, B cols {g} x rows
// {2t, 2t+1, 2t+8, 2t+9}, C rows {g, g+8} x cols {2t, 2t+1}.
__global__ void __launch_bounds__(kThreads)
mha_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, int Lq, int Lk, int H,
                    Strides sq, Strides sk, Strides sv, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBM][kLds];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBN][kLds];
  __shared__ __align__(16) __nv_bfloat16 Vt[kD][kLds];  // V transposed: [d][key]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const uint8_t* mb = mask ? mask + (long long)b * Lk : nullptr;

  // stage the Q tile: 64 rows x 8 chunks of 16 bytes; rows past Lq are zero
  for (int c = tid; c < kBM * (kD / 8); c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + r < Lq)
      val = *reinterpret_cast<const int4*>(qb + (long long)(q0 + r) * sq.l + col);
    *reinterpret_cast<int4*>(&Qs[r][col]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    qf[ks][0] = ld32(&Qs[r0][c0]);
    qf[ks][1] = ld32(&Qs[r0 + 8][c0]);
    qf[ks][2] = ld32(&Qs[r0][c0 + 8]);
    qf[ks][3] = ld32(&Qs[r0 + 8][c0 + 8]);
  }

  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8, raw score units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int k0 = 0; k0 < Lk; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBN * (kD / 8); c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const int4*>(kb + (long long)(k0 + r) * sk.l + col);
        vv = *reinterpret_cast<const int4*>(vb + (long long)(k0 + r) * sv.l + col);
      }
      *reinterpret_cast<int4*>(&Ks[r][col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[col + j][r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const int n = nt * 8 + g, kk = ks * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(&Ks[n][kk]), ld32(&Ks[n][kk + 8])};
        mma_bf16_16816(s[nt], qf[ks], bf);
      }
    }

    // key padding: the ragged tail and the caller's mask become -inf
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        if (key >= Lk || (mb != nullptr && mb[key])) s[nt][i] = -INFINITY;
      }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    float base[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // all keys masked so far
      corr[r] = exp2f((m_run[r] - base[r]) * scale_log2);
      m_run[r] = mx[r];
    }

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f((s[nt][i] - base[i >> 1]) * scale_log2);
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dt][i] *= corr[i >> 1];

    // O += P V: the S accumulators of n-tiles (2kc, 2kc+1) are exactly the
    // A fragment of the 16-key chunk kc
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const int n = dt * 8 + g, kk = kc * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(&Vt[n][kk]), ld32(&Vt[n][kk + 8])};
        mma_bf16_16816(o[dt], pa, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16(o[dt][2 * r] / l_run[r], o[dt][2 * r + 1] / l_run[r]);
    }
  }
}

// f32 inputs: one thread per query row, q and the output row in registers,
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

}  // namespace

extern "C" int mars5_mha_fwd(int is_bf16, const void* q, const void* k,
                             const void* v, const void* mask, void* out, int B,
                             int Lq, int Lk, int H, int D, long long sqb,
                             long long sql, long long sqh, long long skb,
                             long long skl, long long skh, long long svb,
                             long long svl, long long svh, float scale,
                             void* stream) {
  if (D != kD || B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  if (is_bf16) {
    const dim3 grid((Lq + kBM - 1) / kBM, H, B);
    mha_fwd_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), m, static_cast<__nv_bfloat16*>(out),
        Lq, Lk, H, sq, sk, sv, scale_log2);
  } else {
    const dim3 grid((Lq + kFRows - 1) / kFRows, H, B);
    mha_fwd_f32_kernel<<<grid, kFRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), m, static_cast<float*>(out), Lq, Lk, H, sq,
        sk, sv, scale_log2);
  }
  return (int)cudaGetLastError();
}
