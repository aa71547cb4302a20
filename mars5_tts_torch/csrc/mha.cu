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
