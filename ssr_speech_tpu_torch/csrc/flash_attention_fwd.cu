// Flash-attention forward for Hopper (sm_90a): causal + segment-id mask.
//
// Replaces the Pallas TPU kernels behind ssr_speech_tpu/ops/flash_attention.py
// (`_kernel_attend`, the library flash_attention forward, and `_splash_attend`,
// the splash forward). Same math as `reference_attend` there:
//
//   out[b,h,i] = softmax_j( q[b,h,i].k[b,h,j] * sm_scale  over
//                           j <= i  and  seg[b,i] == seg[b,j] ) . v[b,h,j]
//
// with an online softmax and fp32 accumulation. Inputs are bf16 [B, H, S, 128]
// contiguous, seg is int32 [B, S] with any ids; any S is accepted (rows past S
// arrive as zeros from the TMA unit and are masked, nothing is padded). A row
// always sees its own diagonal.
//
// Design. The work is 4 S^2/2 Dh flops a head over a few MB, far above the
// card's flops-per-byte balance: bound by the tensor cores. One block per
// (64-query tile, head, batch row) holds two warpgroups:
//  * a producer warp (its warpgroup gives its registers away with setmaxnreg)
//    starts TMA loads of K and V tiles of 64 keys into a ring of two stages,
//    each with a full/empty mbarrier pair; its lanes also stage the tile's
//    segment ids. Q's load is started by the thread that initialises the
//    barriers, before the tile flags are computed, so it runs beside them;
//  * a consumer warpgroup owns the 64 query rows: S = Q.K^T is wgmma m64n64k16
//    with both operands in shared memory (128-byte swizzle, as TMA wrote
//    them), the online softmax runs on the accumulators in registers, P is
//    rounded to bf16 into the A fragments of O += P.V (wgmma m64n128k16, V
//    read [key][dh] through the transpose bit), O stays in 64 registers.
// The output leaves through Q's buffer as 16-byte coalesced stores.
// A block's fixed cost matters as much as its products: at [128,16,64,128]
// (H100 80GB HBM3, 700 W; flash_bench.py) 2,048 blocks of one tile each took
// 0.056 ms, 7.3 us a block with two on an SM, as long as several tiles of
// products. Starting Q early, starting a tile's TMA before fetching its ids
// while the ring fills, and the coalesced stores took the kernel at
// [18,16,1152,128] from 0.241 to 0.214 ms.
// Two blocks share an SM (84 KB of shared memory each; the consumer asks for
// 216 registers a thread, the producer keeps 40), so one block's softmax
// overlaps the other's products. The row max is taken on the raw scores and
// the scaling folded into the exponent's multiply-add, which needs
// sm_scale > 0 (anything else is refused).
// Key tiles in which no pair can attend are never loaded or multiplied
// (flash_attention_tiles.cuh): those above the diagonal and those whose
// segment-id range is disjoint from the query tile's; tiles of one segment
// below the diagonal skip the per-element mask.
// Query tiles stay 64 rows at every S. Blocks of 128 rows (two consumer
// warpgroups sharing the K/V ring, alone on their SM) were measured beside
// them on an H100 80GB HBM3 at 700 W: 0.277 against 0.281 ms at the training
// shape [18,16,1152,128], 0.0133 against 0.0116 ms at the one-row prefill
// [1,16,384,128], 0.0134-0.0163 against 0.0141 ms at [2,16,384,128]: no gain
// where it could matter and a loss on the small grids, so one shape serves all.
//
// With a non-null `lse` it also writes each row's log-sum-exp (fp32, natural
// log of the scaled scores), which the backward (flash_attention_bwd.cu)
// reads instead of recomputing the softmax statistics.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "flash_attention_tiles.cuh"

namespace {

using namespace ssr;
using namespace ssr::flash;

constexpr int kStages = 2;
constexpr int kThreads = 256;  // consumer warpgroup, producer warpgroup
// shared memory, from a 1024-byte boundary
constexpr int kOffQ = 0;
constexpr int kOffKV = kTileBytes;                           // stage: K tile, V tile
constexpr int kOffSeg = kOffKV + kStages * 2 * kTileBytes;   // stage: 64 ids
constexpr int kOffBar = kOffSeg + kStages * kTile * 4;       // q, full[], empty[]
constexpr int kOffFlags = kOffBar + 8 * (1 + 2 * kStages);   // one byte a key tile

long long g_encode_ns = 0;  // host time of the last launch's tensor-map encodes

size_t smem_bytes(int S) { return 1024 + kOffFlags + (S + kTile - 1) / kTile + 16; }

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                 uint16_t* __restrict__ out, float* __restrict__ lse, int H, int S,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  int* seg_s = reinterpret_cast<int*>(gen + kOffSeg);
  unsigned char* flags = gen + kOffFlags;
  const uint32_t q_bar = base + kOffBar;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  // the last query tiles carry the most keys: launch them first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = m_block * kTile;
  const int* segb = seg + static_cast<size_t>(b) * S;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 2);   // the TMA request, and the ids staged
      mbar_init(empty_bar + 8 * s, 4);  // one arrival a consumer warp
    }
    mbar_fence_init();
    // Q does not wait for the flags: its load runs beside their computation
    tma_prefetch_map(&qmap);
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    mbar_arrive_expect_tx(q_bar, kTileBytes);
    tma_load_tile128(base + kOffQ, &qmap, q_bar, m0, bh, kTile);
  }
  key_tile_flags(flags, segb, m_block, S, tid, kThreads);
  __syncthreads();

  if (warpgroup_index() == 1) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (tid >= 160) return;
    produce_kv_tiles<kStages>(flags, m_block, segb, S, bh, seg_s, base + kOffKV, full_bar,
                              empty_bar, &kmap, &vmap, lane);
  } else {
    // ------------------------------------------------------------ consumer
    reg_alloc<216>();
    const int warp = tid >> 5;
    const int g = lane >> 2;   // row within the warp's 8-row half
    const int t4 = lane & 3;   // column pair within an 8-column block
    const int row0 = m0 + warp * 16 + g;  // this thread's two rows
    const int row1 = row0 + 8;
    const bool in0 = row0 < S;
    const bool in1 = row1 < S;
    const int seg0 = in0 ? segb[row0] : 0;
    const int seg1 = in1 ? segb[row1] : 0;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

    mbar_wait(q_bar, 0);
    int it = 0;
    for (int n = 0; n <= m_block; ++n) {
      const unsigned char flag = flags[n];
      if (flag == kSkip) continue;
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      ++it;
      const uint32_t k_s = base + kOffKV + stage * 2 * kTileBytes;
      const uint32_t v_s = k_s + kTileBytes;
      mbar_wait(full_bar + 8 * stage, parity);

      // scores for 64 rows x 64 keys
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wgmma_m64n64k16_ss(s, desc_kmajor(base + kOffQ, kTile, kk),
                           desc_kmajor(k_s, kTile, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);

      // mask, then the row max of the raw scores over the 4 lanes of a row
      // (sm_scale > 0, so the max commutes with the scaling, which is folded
      // into the exponent's one multiply-add)
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (flag == kDense) {
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
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
            const float x0 = attends(row0, key, S, seg0, sk) ? s[4 * j + e] : -INFINITY;
            const float x1 = attends(row1, key, S, seg1, sk) ? s[4 * j + 2 + e] : -INFINITY;
            s[4 * j + e] = x0;
            s[4 * j + 2 + e] = x1;
            mx0 = fmaxf(mx0, x0);
            mx1 = fmaxf(mx1, x1);
          }
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

      const float new0 = fmaxf(m_run[0], mx0);
      const float new1 = fmaxf(m_run[1], mx1);
      // a row with no visible key yet (its first visited tile may hold none)
      // keeps max -inf: subtract 0 instead, so exp2(-inf - 0) = 0, not NaN
      const float nb0 = new0 == -INFINITY ? 0.f : -new0 * scale_log2;
      const float nb1 = new1 == -INFINITY ? 0.f : -new1 * scale_log2;
      const float alpha0 = fast_exp2(fmaf(m_run[0], scale_log2, nb0));
      const float alpha1 = fast_exp2(fmaf(m_run[1], scale_log2, nb1));
      m_run[0] = new0;
      m_run[1] = new1;
      l_run[0] *= alpha0;
      l_run[1] *= alpha1;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, nb0));
        s[i + 1] = fast_exp2(fmaf(s[i + 1], scale_log2, nb0));
        s[i + 2] = fast_exp2(fmaf(s[i + 2], scale_log2, nb1));
        s[i + 3] = fast_exp2(fmaf(s[i + 3], scale_log2, nb1));
        l_run[0] += s[i] + s[i + 1];
        l_run[1] += s[i + 2] + s[i + 3];
      }

      // O += P.V: two adjacent 8-key blocks of P are the A fragment of one
      // 16-key step, rounded to bf16 here
      uint32_t pa[kTile / 16][4];
      pack_fragments(s, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_m64n128k16_rs_tb(o, pa[kk], desc_mnmajor(v_s, kTile, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
    }

    float l0 = l_run[0], l1 = l_run[1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const size_t head = static_cast<size_t>(bh) * S;
    if (lse != nullptr && t4 == 0) {
      // natural-log log-sum-exp of the scaled scores: l is in the log2 domain
      // of scores * sm_scale, relative to m
      constexpr float kLn2 = 0.6931471805599453f;
      if (in0) lse[head + row0] = (m_run[0] * scale_log2 + log2f(l0)) * kLn2;
      if (in1) lse[head + row1] = (m_run[1] * scale_log2 + log2f(l1)) * kLn2;
    }
    // through the Q tile's buffer, which no product reads any more
    store_tile_bf16(o, inv0, inv1, gen + kOffQ, out + head * kHeadDim, m0, S, 0, tid);
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): a
// refused launch (bad shape, a tensor map that fails to encode, too much shared
// memory) is reported here, not at the next synchronise. Returns
// cudaErrorInvalidValue for shapes the kernel does not take. `lse` (fp32
// [B, H, S], the per-row log-sum-exp the backward needs) may be null: the
// serving path does not keep it.
extern "C" int ssr_flash_attention_fwd_bf16(const void* q, const void* k,
                                            const void* v, const void* seg,
                                            void* out, void* lse, int B, int H,
                                            int S, int head_dim, float sm_scale,
                                            void* stream) {
  if (head_dim != kHeadDim || B <= 0 || H <= 0 || S <= 0 || S > kMaxSeq || H > 65535 ||
      B > 65535 || !(sm_scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB is per device: set it on every call (it is cheap).
  // First, because a runtime call binds the device's context to this thread,
  // which cuTensorMapEncodeTiled below needs (autograd runs on its own threads).
  const size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the maps hold the tensors' addresses: encoded for every launch
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap qmap, kmap, vmap;
  err = encode_heads_map(&qmap, q, B * H, S, kTile);
  if (err == cudaSuccess) err = encode_heads_map(&kmap, k, B * H, S, kTile);
  if (err == cudaSuccess) err = encode_heads_map(&vmap, v, B * H, S, kTile);
  if (err != cudaSuccess) return static_cast<int>(err);
  g_encode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count();
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<const int*>(seg), static_cast<uint16_t*>(out),
      static_cast<float*>(lse), H, S, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Host nanoseconds the last launch spent encoding its three tensor maps.
extern "C" long long ssr_flash_attention_fwd_encode_ns() { return g_encode_ns; }
