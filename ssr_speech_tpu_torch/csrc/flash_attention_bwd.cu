// Flash-attention backward for Hopper (sm_90a): causal + segment-id mask.
//
// Replaces the backward of the Pallas TPU kernels behind
// ssr_speech_tpu/ops/flash_attention.py: the library flash_attention custom
// VJP (`_kernel_attend`) and splash's fused dq/dkv kernel (`_splash_attend`,
// block sizes at :130-131). Given the forward's output O and per-row
// log-sum-exp L (flash_attention_fwd.cu), and dO, with P = softmax(Q.K^T * s)
// under the mask j <= i and seg[b,i] == seg[b,j]:
//
//   D[i]  = rowsum(dO[i] * O[i])
//   P[i,j] = exp(q_i.k_j * s - L[i])            (0 where masked)
//   dS    = P * (dO.V^T - D)
//   dQ    = dS.K * s,   dK = dS^T.Q * s,   dV = P^T.dO
//
// Inputs bf16 [B, H, S, 128] contiguous, seg int32 [B, S] with any ids, L fp32
// [B, H, S]; any S (rows past S arrive as zeros from the TMA unit and are
// masked, nothing is padded). Every row, of any segment, is defined.
//
// Design: bound by the tensor cores (about 2.5x the forward's flops). Two
// kernels and no float atomics, so the gradients are bit-reproducible; every
// product is a wgmma, every tile arrives by TMA into an mbarrier ring, a
// producer warp starts the loads and gives its registers to the consumers
// (setmaxnreg), and tiles in which no pair can attend are skipped
// (flash_attention_tiles.cuh).
//  * In both kernels the thread that initialises the barriers starts the loads
//    that need no tile flag (dq: Q and dO; dk/dv: K, V and the diagonal's Q and
//    dO) before the flags are computed, and while the ring fills the producer
//    starts a tile's TMA before it fetches the tile's rows from global memory:
//    a block's life before its first product is as long as a few tiles.
//  * dq kernel: one block per (64-query tile, head, batch row), two blocks an
//    SM. The consumer warpgroup computes D for its rows (written out for the
//    second kernel), keeps dQ (64 x 128 fp32) in registers, and for each
//    visited key tile runs S = Q.K^T and dP = dO.V^T (m64n64k16, operands in
//    shared memory), forms dS in registers and feeds it as the A fragments of
//    dQ += dS.K (m64n128k16, K read [key][dh] through the transpose bit).
//  * dk/dv kernel: one block per (64-key tile, head, batch row) with two
//    consumer warpgroups that share the stream of Q/dO tiles (ring of three
//    stages, with the rows' L, D and ids staged beside them). Keys are the M
//    side. The dV warpgroup computes S^T = K.Q^T and P^T and accumulates
//    dV += P^T.dO; the dK warpgroup computes dP^T = V.dO^T, takes P^T from the
//    first through shared memory (fp32, so dS is rounded where it always
//    was), and accumulates dK += dS^T.Q: two products each and one 64 x 128
//    accumulator a thread. dK and dV leave through V's and K's buffers as
//    16-byte coalesced stores. Measured on an H100 80GB HBM3 at 700 W, both
//    kernels together at [18,16,1152,128] with a padded batch's segments:
//    0.92 ms so (0.79 since the early loads and the coalesced stores, which
//    came later), 0.95 ms with both warpgroups computing S^T for themselves
//    (no hand-over, five products a tile), and 1.78 ms with dK, dV, S^T and
//    dP^T all in one warpgroup of 64 keys, two such warpgroups a block (192
//    accumulator registers a thread: the compiler spilled 850 bytes a thread
//    and serialised every wgmma).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tiles.cuh"

namespace {

using namespace ssr;
using namespace ssr::flash;

// ------------------------------------------------------------------ dq kernel
constexpr int kDqStages = 2;
constexpr int kDqThreads = 256;  // consumer warpgroup, producer warpgroup
constexpr int kDqOffQ = 0;       // Q tile, dO tile
constexpr int kDqOffKV = 2 * kTileBytes;                            // stage: K, V
constexpr int kDqOffSeg = kDqOffKV + kDqStages * 2 * kTileBytes;    // stage: 64 ids
constexpr int kDqOffBar = kDqOffSeg + kDqStages * kTile * 4;        // q, full[], empty[]
constexpr int kDqOffFlags = kDqOffBar + 8 * (1 + 2 * kDqStages);

size_t dq_smem_bytes(int S) { return 1024 + kDqOffFlags + (S + kTile - 1) / kTile + 16; }

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// sum over 8 bf16 pairs of a 16-byte chunk
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  return bf16_lo(a.x) * bf16_lo(b.x) + bf16_hi(a.x) * bf16_hi(b.x) +
         bf16_lo(a.y) * bf16_lo(b.y) + bf16_hi(a.y) * bf16_hi(b.y) +
         bf16_lo(a.z) * bf16_lo(b.z) + bf16_hi(a.z) * bf16_hi(b.z) +
         bf16_lo(a.w) * bf16_lo(b.w) + bf16_hi(a.w) * bf16_hi(b.w);
}

// D of one row: this lane's quarter (32 columns), then the 4 lanes of the row
__device__ __forceinline__ float row_dot(const uint16_t* a, const uint16_t* b, int row, bool in,
                                         int t4) {
  float d = 0.f;
  if (in) {
    const uint4* pa = reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * kHeadDim) + t4 * 4;
    const uint4* pb = reinterpret_cast<const uint4*>(b + static_cast<size_t>(row) * kHeadDim) + t4 * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) d += dot8(pa[i], pb[i]);
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  return d;
}

__global__ void __launch_bounds__(kDqThreads, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const int* __restrict__ seg,
                    const uint16_t* __restrict__ out, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    uint16_t* __restrict__ dq, int H, int S, float scale_log2, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  int* seg_s = reinterpret_cast<int*>(gen + kDqOffSeg);
  unsigned char* flags = gen + kDqOffFlags;
  const uint32_t q_bar = base + kDqOffBar;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kDqStages;

  const int m_block = gridDim.x - 1 - blockIdx.x;  // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = m_block * kTile;
  const int* segb = seg + static_cast<size_t>(b) * S;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full_bar + 8 * s, 2);   // the TMA request, and the ids staged
      mbar_init(empty_bar + 8 * s, 4);  // one arrival a consumer warp
    }
    mbar_fence_init();
    // Q and dO do not wait for the flags: they load beside their computation
    tma_prefetch_map(&qmap);
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    tma_prefetch_map(&domap);
    mbar_arrive_expect_tx(q_bar, 2 * kTileBytes);
    tma_load_tile128(base + kDqOffQ, &qmap, q_bar, m0, bh, kTile);
    tma_load_tile128(base + kDqOffQ + kTileBytes, &domap, q_bar, m0, bh, kTile);
  }
  key_tile_flags(flags, segb, m_block, S, tid, kDqThreads);
  __syncthreads();

  if (warpgroup_index() == 1) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (tid >= 160) return;
    produce_kv_tiles<kDqStages>(flags, m_block, segb, S, bh, seg_s, base + kDqOffKV, full_bar,
                                empty_bar, &kmap, &vmap, lane);
  } else {
    // ------------------------------------------------------------ consumer
    reg_alloc<216>();
    const int warp = tid >> 5;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int row0 = m0 + warp * 16 + g;
    const int row1 = row0 + 8;
    const bool in0 = row0 < S;
    const bool in1 = row1 < S;
    const size_t head = static_cast<size_t>(bh) * S;
    const int seg0 = in0 ? segb[row0] : 0;
    const int seg1 = in1 ? segb[row1] : 0;
    const float lse0 = in0 ? lse[head + row0] * kLog2e : 0.f;
    const float lse1 = in1 ? lse[head + row1] * kLog2e : 0.f;

    // D = rowsum(dO * O), kept for this kernel and written for the next
    const float d0 = row_dot(dout + head * kHeadDim, out + head * kHeadDim, row0, in0, t4);
    const float d1 = row_dot(dout + head * kHeadDim, out + head * kHeadDim, row1, in1, t4);
    if (t4 == 0) {
      if (in0) dsum[head + row0] = d0;
      if (in1) dsum[head + row1] = d1;
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    const uint32_t q_s = base + kDqOffQ;
    const uint32_t do_s = q_s + kTileBytes;
    mbar_wait(q_bar, 0);
    int it = 0;
    for (int n = 0; n <= m_block; ++n) {
      const unsigned char flag = flags[n];
      if (flag == kSkip) continue;
      const int stage = it % kDqStages;
      const uint32_t parity = (it / kDqStages) & 1;
      ++it;
      const uint32_t k_s = base + kDqOffKV + stage * 2 * kTileBytes;
      const uint32_t v_s = k_s + kTileBytes;
      mbar_wait(full_bar + 8 * stage, parity);

      // S = Q.K^T and dP = dO.V^T for 64 rows x 64 keys
      float s[32];
      float dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wgmma_m64n64k16_ss(s, desc_kmajor(q_s, kTile, kk), desc_kmajor(k_s, kTile, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wgmma_m64n64k16_ss(dp, desc_kmajor(do_s, kTile, kk), desc_kmajor(v_s, kTile, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);

      // dS = P * (dP - D), masked entries 0; kept in s
      if (flag == kDense) {
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          s[i] = fast_exp2(s[i] * scale_log2 - lse0) * (dp[i] - d0);
          s[i + 1] = fast_exp2(s[i + 1] * scale_log2 - lse0) * (dp[i + 1] - d0);
          s[i + 2] = fast_exp2(s[i + 2] * scale_log2 - lse1) * (dp[i + 2] - d1);
          s[i + 3] = fast_exp2(s[i + 3] * scale_log2 - lse1) * (dp[i + 3] - d1);
        }
      } else {
        const int* ids = seg_s + stage * kTile;
        const int n0 = n * kTile;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 id = *reinterpret_cast<const int2*>(ids + j * 8 + t4 * 2);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = n0 + j * 8 + t4 * 2 + e;
            const int sk = e == 0 ? id.x : id.y;
            const float p0 = attends(row0, key, S, seg0, sk)
                                 ? fast_exp2(s[4 * j + e] * scale_log2 - lse0) : 0.f;
            const float p1 = attends(row1, key, S, seg1, sk)
                                 ? fast_exp2(s[4 * j + 2 + e] * scale_log2 - lse1) : 0.f;
            s[4 * j + e] = p0 * (dp[4 * j + e] - d0);
            s[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - d1);
          }
        }
      }

      // dQ += dS.K: K's rows are the 16-deep k steps
      uint32_t a[kTile / 16][4];
      pack_fragments(s, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_m64n128k16_rs_tb(acc, a[kk], desc_mnmajor(k_s, kTile, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
    }

    // Stored straight from the accumulators: with dQ, S and dP live this
    // kernel has no registers to spare, and store_tile_bf16 made ptxas spill
    // 444 bytes a thread and serialise the wgmmas (0.52-0.56 ms against 0.29
    // on an H100 80GB HBM3 at 700 W).
    uint16_t* dqh = dq + head * kHeadDim;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      const int c = dt * 8 + t4 * 2;
      if (in0) {
        *reinterpret_cast<uint32_t*>(dqh + static_cast<size_t>(row0) * kHeadDim + c) =
            pack_bf16(acc[4 * dt] * sm_scale, acc[4 * dt + 1] * sm_scale);
      }
      if (in1) {
        *reinterpret_cast<uint32_t*>(dqh + static_cast<size_t>(row1) * kHeadDim + c) =
            pack_bf16(acc[4 * dt + 2] * sm_scale, acc[4 * dt + 3] * sm_scale);
      }
    }
  }
}

// --------------------------------------------------------------- dk/dv kernel
constexpr int kKvStages = 3;
constexpr int kKvThreads = 384;  // dV warpgroup, dK warpgroup, producer warpgroup
constexpr int kKvOffK = 0;       // K tile, V tile
constexpr int kKvOffQ = 2 * kTileBytes;                             // stage: Q, dO
constexpr int kKvOffRows = kKvOffQ + kKvStages * 2 * kTileBytes;    // stage: L, D, ids
constexpr int kKvRowBytes = 3 * kTile * 4;
constexpr int kKvOffP = kKvOffRows + kKvStages * kKvRowBytes;       // stage: P^T, fp32
constexpr int kKvPBytes = kTile * kTile * 4;
constexpr int kKvOffBar = kKvOffP + kKvStages * kKvPBytes;          // kv, full[], empty[], p[]
constexpr int kKvOffFlags = kKvOffBar + 8 * (1 + 3 * kKvStages);    // a byte a query tile

size_t dkdv_smem_bytes(int S) { return 1024 + kKvOffFlags + (S + kTile - 1) / kTile + 16; }

// Q and dO tiles of 64 queries from row m0 into a stage of the ring, by one
// thread.
__device__ __forceinline__ void start_q_tile(uint32_t base, uint32_t full_bar, int stage,
                                             const CUtensorMap* qmap, const CUtensorMap* domap,
                                             int m0, int bh) {
  const uint32_t dst = base + kKvOffQ + stage * 2 * kTileBytes;
  mbar_arrive_expect_tx(full_bar + 8 * stage, 2 * kTileBytes);
  tma_load_tile128(dst, qmap, full_bar + 8 * stage, m0, bh, kTile);
  tma_load_tile128(dst + kTileBytes, domap, full_bar + 8 * stage, m0, bh, kTile);
}

// What both consumer warpgroups of the dk/dv kernel know.
struct KvWalk {
  uint32_t base;          // shared memory, 1024-byte aligned
  float* rows_s;          // stage: L, D, ids of the 64 queries
  float* p_s;             // stage: P^T as thread t's 32 accumulators at [i][t]
  const unsigned char* flags;
  uint32_t kv_bar, full_bar, empty_bar, p_bar;
  int kt, n_qtiles, S;
};

// The dV warpgroup: S^T = K.Q^T, P^T = exp(S^T * scale - L) under the mask,
// handed to the dK warpgroup through shared memory in fp32, dV += P^T.dO.
__device__ __forceinline__ void consume_dv(float (&acc)[64], const KvWalk& w, int key0, int key1,
                                           int segk0, int segk1, float scale_log2, int lane,
                                           int tid_in_group) {
  const int t4 = lane & 3;
  const uint32_t k_s = w.base + kKvOffK;
  mbar_wait(w.kv_bar, 0);
  int it = 0;
  for (int m = w.kt; m < w.n_qtiles; ++m) {  // queries from the diagonal down
    const unsigned char flag = w.flags[m];
    if (flag == kSkip) continue;
    const int stage = it % kKvStages;
    const uint32_t parity = (it / kKvStages) & 1;
    ++it;
    mbar_wait(w.full_bar + 8 * stage, parity);
    const uint32_t q_s = w.base + kKvOffQ + stage * 2 * kTileBytes;
    const uint32_t do_s = q_s + kTileBytes;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      wgmma_m64n64k16_ss(s, desc_kmajor(k_s, kTile, kk), desc_kmajor(q_s, kTile, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    const float* rows = w.rows_s + stage * 3 * kTile;
    const int* ids = reinterpret_cast<const int*>(rows) + 2 * kTile;
    const int m0 = m * kTile;
    float* p_out = w.p_s + stage * kTile * kTile + tid_in_group;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int il = j * 8 + t4 * 2;
      const float2 lq = *reinterpret_cast<const float2*>(rows + il);
      const int2 id = *reinterpret_cast<const int2*>(ids + il);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = m0 + il + e;
        const float lqe = e == 0 ? lq.x : lq.y;
        const int sq = e == 0 ? id.x : id.y;
        const bool ok0 = flag == kDense || attends(i, key0, w.S, sq, segk0);
        const bool ok1 = flag == kDense || attends(i, key1, w.S, sq, segk1);
        s[4 * j + e] = ok0 ? fast_exp2(s[4 * j + e] * scale_log2 - lqe) : 0.f;
        s[4 * j + 2 + e] = ok1 ? fast_exp2(s[4 * j + 2 + e] * scale_log2 - lqe) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p_out[i * 128] = s[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(w.p_bar + 8 * stage);

    // dV += P^T.dO: the queries are the 16-deep k steps
    uint32_t a[kTile / 16][4];
    pack_fragments(s, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64n128k16_rs_tb(acc, a[kk], desc_mnmajor(do_s, kTile, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(w.empty_bar + 8 * stage);
  }
}

// The dK warpgroup: dP^T = V.dO^T, dS^T = P^T * (dP^T - D) with the dV
// warpgroup's P^T (its thread t holds what thread t here needs: the two
// warpgroups own the same 64 x 64 tile in the same layout), dK += dS^T.Q.
__device__ __forceinline__ void consume_dk(float (&acc)[64], const KvWalk& w, int lane,
                                           int tid_in_group) {
  const int t4 = lane & 3;
  const uint32_t v_s = w.base + kKvOffK + kTileBytes;
  mbar_wait(w.kv_bar, 0);
  int it = 0;
  for (int m = w.kt; m < w.n_qtiles; ++m) {
    if (w.flags[m] == kSkip) continue;
    const int stage = it % kKvStages;
    const uint32_t parity = (it / kKvStages) & 1;
    ++it;
    mbar_wait(w.full_bar + 8 * stage, parity);
    const uint32_t q_s = w.base + kKvOffQ + stage * 2 * kTileBytes;
    const uint32_t do_s = q_s + kTileBytes;

    float dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      wgmma_m64n64k16_ss(dp, desc_kmajor(v_s, kTile, kk), desc_kmajor(do_s, kTile, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dp);

    const float* dsum_q = w.rows_s + stage * 3 * kTile + kTile;
    const float* p_in = w.p_s + stage * kTile * kTile + tid_in_group;
    mbar_wait(w.p_bar + 8 * stage, parity);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(dsum_q + j * 8 + t4 * 2);
      dp[4 * j] = p_in[(4 * j) * 128] * (dp[4 * j] - d.x);
      dp[4 * j + 1] = p_in[(4 * j + 1) * 128] * (dp[4 * j + 1] - d.y);
      dp[4 * j + 2] = p_in[(4 * j + 2) * 128] * (dp[4 * j + 2] - d.x);
      dp[4 * j + 3] = p_in[(4 * j + 3) * 128] * (dp[4 * j + 3] - d.y);
    }

    uint32_t a[kTile / 16][4];
    pack_fragments(dp, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64n128k16_rs_tb(acc, a[kk], desc_mnmajor(q_s, kTile, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(w.empty_bar + 8 * stage);
  }
}

__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap, const int* __restrict__ seg,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int H, int S,
                      float scale_log2, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  float* rows_s = reinterpret_cast<float*>(gen + kKvOffRows);
  unsigned char* flags = gen + kKvOffFlags;
  const uint32_t kv_bar = base + kKvOffBar;
  const uint32_t full_bar = kv_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kKvStages;
  const uint32_t p_bar = empty_bar + 8 * kKvStages;

  const int n_qtiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // the first key tiles walk the most queries
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t head = static_cast<size_t>(bh) * S;
  const int* segb = seg + static_cast<size_t>(b) * S;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full_bar + 8 * s, 2);   // the TMA request, and the rows staged
      mbar_init(empty_bar + 8 * s, 8);  // one arrival a consumer warp
      mbar_init(p_bar + 8 * s, 4);      // one arrival a warp of the dV warpgroup
    }
    mbar_fence_init();
    // What needs no flag loads beside their computation: K and V, and the Q
    // and dO tiles of the diagonal (query tile kt, always visited) into
    // stage 0, whose rows the producer stages below.
    tma_prefetch_map(&qmap);
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    tma_prefetch_map(&domap);
    mbar_arrive_expect_tx(kv_bar, 2 * kTileBytes);
    tma_load_tile128(base + kKvOffK, &kmap, kv_bar, kt * kTile, bh, kTile);
    tma_load_tile128(base + kKvOffK + kTileBytes, &vmap, kv_bar, kt * kTile, bh, kTile);
    start_q_tile(base, full_bar, 0, &qmap, &domap, kt * kTile, bh);
  }
  {  // flags of this key tile's query tiles kt.., a warp a tile
    int kmn, kmx;
    tile_seg_range(segb, kt, S, lane, kmn, kmx);
    for (int m = kt + (tid >> 5); m < n_qtiles; m += kKvThreads / 32) {
      int qmn, qmx;
      tile_seg_range(segb, m, S, lane, qmn, qmx);
      if (lane == 0) flags[m] = tile_flag(m, kt, S, qmn, qmx, kmn, kmx);
    }
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (tid >= 256 + 32) return;
    int it = 0;
    for (int m = kt; m < n_qtiles; ++m) {
      if (flags[m] == kSkip) continue;
      const int stage = it % kKvStages;
      const uint32_t parity = ((it / kKvStages) & 1) ^ 1;
      // While the ring fills, the stage is free: start the TMA loads before
      // the rows' round trip to global memory (the diagonal's were started
      // with K and V). Once it is full, fetch the rows while waiting for the
      // consumers to free the stage.
      const bool filling = it < kKvStages;
      const bool started = it == 0;
      ++it;
      const int m0 = m * kTile;
      if (filling && !started) {
        mbar_wait(empty_bar + 8 * stage, parity);
        if (lane == 0) start_q_tile(base, full_bar, stage, &qmap, &domap, m0, bh);
      }
      float l[2], d[2];
      int id[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = m0 + 32 * e + lane;
        const bool in = i < S;
        l[e] = in ? lse[head + i] * kLog2e : 0.f;
        d[e] = in ? dsum[head + i] : 0.f;
        id[e] = in ? segb[i] : 0;
      }
      if (!filling) {
        mbar_wait(empty_bar + 8 * stage, parity);
        if (lane == 0) start_q_tile(base, full_bar, stage, &qmap, &domap, m0, bh);
      }
      float* rows = rows_s + stage * 3 * kTile;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rows[32 * e + lane] = l[e];
        rows[kTile + 32 * e + lane] = d[e];
        reinterpret_cast<int*>(rows)[2 * kTile + 32 * e + lane] = id[e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full_bar + 8 * stage);
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<224>();
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int key0 = kt * kTile + warp * 16 + g;  // this thread's two keys
    const int key1 = key0 + 8;
    const bool in0 = key0 < S;
    const bool in1 = key1 < S;
    const int segk0 = in0 ? segb[key0] : 0;
    const int segk1 = in1 ? segb[key1] : 0;
    const KvWalk walk = {base, rows_s, reinterpret_cast<float*>(gen + kKvOffP), flags, kv_bar,
                         full_bar, empty_bar, p_bar, kt, n_qtiles, S};
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // Each warpgroup stores through the operand tile that only it read: the
    // dV warpgroup through K's buffer, the dK warpgroup through V's.
    if (role == 1) {
      consume_dk(acc, walk, lane, tid & 127);
      store_tile_bf16(acc, sm_scale, sm_scale, gen + kKvOffK + kTileBytes,
                      dk + head * kHeadDim, kt * kTile, S, 1, tid & 127);
    } else {
      consume_dv(acc, walk, key0, key1, segk0, segk1, scale_log2, lane, tid & 127);
      store_tile_bf16(acc, 1.f, 1.f, gen + kKvOffK, dv + head * kHeadDim, kt * kTile, S, 0,
                      tid & 127);
    }
  }
}

}  // namespace

// Launches both kernels on `stream` (dq first: it writes D, which the dk/dv
// kernel reads) and returns cudaGetLastError(). `dsum` is fp32 [B, H, S]
// scratch. Returns cudaErrorInvalidValue for shapes the kernels do not take.
extern "C" int ssr_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                            const void* seg, const void* out,
                                            const void* dout, const void* lse,
                                            void* dsum, void* dq, void* dk, void* dv,
                                            int B, int H, int S, int head_dim,
                                            float sm_scale, void* stream) {
  if (head_dim != kHeadDim || B <= 0 || H <= 0 || S <= 0 || S > kMaxSeq || H > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB is per device: set it on every call (it is cheap).
  // First, because a runtime call binds the device's context to this thread,
  // which cuTensorMapEncodeTiled below needs (autograd runs on its own threads).
  const size_t dq_smem = dq_smem_bytes(S);
  const size_t kv_smem = dkdv_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dq_smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kv_smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the maps hold the tensors' addresses: encoded for every launch
  CUtensorMap qmap, kmap, vmap, domap;
  err = encode_heads_map(&qmap, q, B * H, S, kTile);
  if (err == cudaSuccess) err = encode_heads_map(&kmap, k, B * H, S, kTile);
  if (err == cudaSuccess) err = encode_heads_map(&vmap, v, B * H, S, kTile);
  if (err == cudaSuccess) err = encode_heads_map(&domap, dout, B * H, S, kTile);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (S + kTile - 1) / kTile;
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<<<dim3(n_tiles, H, B), kDqThreads, dq_smem, st>>>(
      qmap, kmap, vmap, domap, static_cast<const int*>(seg), static_cast<const uint16_t*>(out),
      static_cast<const uint16_t*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<uint16_t*>(dq), H, S, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<dim3(n_tiles, H, B), kKvThreads,
                          kv_smem, st>>>(
      qmap, kmap, vmap, domap, static_cast<const int*>(seg), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
      H, S, scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
