// Fused CE head for Hopper (sm_90a): the second head matmul, log-softmax,
// target NLL and top-k rank, forward and backward, with no [N, C] logits in
// device memory.
//
// Replaces the Pallas TPU kernels of ssr_speech_tpu/ops/fused_ce.py:
//   ssr_fused_ce_fwd_bf16          <- _fwd_kernel (via _fused_fwd_padded)
//   ssr_fused_ce_bwd_dhidden_bf16  <- _bwd_dhidden_kernel (via _fused_bwd_padded)
//   ssr_fused_ce_bwd_dw2_bf16      <- _bwd_dw2_kernel (via _fused_bwd_padded)
// Same math as `reference_ce_head` there, per codebook k and row n:
//   logits = hidden[k,n] . w2[k] + b2[k]           (fp32 accumulation)
//   logz = logsumexp(logits),  nll = logz - logits[t],  hit = #(logits > logits[t]) < top
//   dlogits = bf16((exp(logits - logz) - onehot(t)) * g)
//   dhidden = dlogits . w2[k]^T,  dw2 = hidden^T . dlogits,  db2 = sum_n dlogits
//
// Inputs: hidden bf16 [K, N, Hh], b2 bf16 [K, C], targets int32 [K, N]; the
// weights as the transpose of w2, w2t bf16 [K, C, Hh], which the wrapper makes
// once a step: its rows are 2 Hh bytes, a pitch the TMA unit takes at any C. Hh a multiple of 128 up
// to 1024, any N and C. The vocab tail is masked by bounds, so columns past C
// never enter logz or the rank (the TPU kernel pads them with a -1e9 bias).
//
// One [N, Hh] x [Hh, C] product is 2 K N Hh C operations (0.22 TFLOP at K = 4,
// N = 13,230, Hh = 1024, C = 2056) over ~130 MB of inputs, far above the
// card's operations-per-byte balance: all three kernels are bound by the
// tensor cores; the backward kernels recompute the logits, so they do two
// products each. The TPU kernels hold a [128, Cp] fp32 logits block in VMEM;
// that does not fit here (227 KB of shared memory and 64 K registers an SM),
// which decides the shapes below.
//
// Forward (`ce_target_logit_kernel`, then `ce_fwd_kernel`). The rank needs the
// target logit before it can count, so a pre-pass computes it first, a warp a
// row, in fp32 from row t of w2t (a contiguous 2 KB read; column t of w2 would
// be a 32-byte sector for every 2 bytes). Then ONE pass over the vocabulary: a
// block owns (k, 128 rows) as two consumer warpgroups of 64 rows and a producer
// warp that keeps a ring of 6 stages filled by TMA, each stage a [128 x 64]
// chunk of hidden and a [128 x 64] chunk of w2t (both with the reduction
// dimension contiguous, 128-byte swizzle). A vocab tile of 128 columns is 16
// chunks x 4 wgmma m64n128k16 a warpgroup into one 64 x 128 fp32 accumulator a
// thread, which starts as the bias (-inf past C, so the mask costs nothing).
// The epilogue stays in registers: a row's 128 columns sit in the 4 threads of
// a quad, so the running max takes two shuffles a row, the sum and the count
// stay partial in each thread until the end (a fixed order: deterministic), and
// exp is ex2 with the scale folded into one multiply-add. The count leaves out
// the target's own column, so it equals the plain version's wherever no other
// logit lies within rounding of the target's. A last tile of at most 8 columns
// (C = 2056 = 16 x 128 + 8) is a wgmma m64n8k16 instead of a 17th full tile
// (5.9% of the products). What it re-reads: [128, 1024] of hidden (256 KB) does
// not fit beside the ring, so a block streams its rows again for every vocab
// tile, and w2t[k] once: 416 blocks x 17 tiles x 512 KB = 3.6 GB through L2 a
// call at the training shape, about 0.65 ms at ~5.5 TB/s against the 0.225 ms
// of products. L2, not the tensor cores, bounds this form; a block that owns
// more rows (two accumulators a thread) would halve the w2t share.
//
// dw2/db2 (`ce_dw2_kernel`). dw2[k] = hidden^T . dlogits is a reduction over N
// with an [Hh, vt] fp32 result a block; registers decide vt: [1024, 32] is 128
// KB, half an SM's register file. A block owns (k, 32 vocab columns) and every
// row of dw2 as two warpgroups of Hh/2 rows each: 8 accumulators m64n32 = 128
// registers a thread. Its [32, Hh] tile of w2t stays in shared memory (64 KB).
// Row blocks of 64 stream through TMA as chunks of [64 rows x 64 columns] of
// hidden, 8 slots a warpgroup (its half of Hh; 128 KB in all). One row block
// serves two products from the same chunks: the logits [64, 32] (each
// warpgroup reduces its half of Hh; the halves are swapped through shared
// memory and each warpgroup finishes 16 of the 32 columns), then, after
// exp(logit - logz), the one-hot and g in registers, rounded to bf16 into a 4 KB
// swizzled tile, dw2 += hidden^T . dlogits with hidden as the A operand read
// through the transpose bit. A chunk's slot is refilled with the next row
// block's chunk as soon as the second product has read it. db2 is the column
// sum of the same bf16 dlogits: eight partial sums a column (8 rows of every
// block each), added in a fixed order at the end. No atomics: the gradients
// are bit-reproducible. There is no producer warp and no setmaxnreg: a ninth
// warp puts three on one scheduler, ptxas then allows 168 registers a thread
// whatever setmaxnreg asks for, spills, and serialises every wgmma (C7512);
// with 8 warps it takes the 185 it needs, and one thread of each warpgroup
// starts its loads. With n = 32 a wgmma reads 3 KB of shared memory for 65 K
// operations, about 2/3 of what the tensor cores could take, and the two
// products of a row block wait on each other through two barriers, so this
// form stops near a third of the peak; a 2-block cluster that splits Hh
// ([512, 64] of dw2 a block) would lift that.
//
// dhidden (`ce_dhidden_kernel`). Its accumulator, [64 rows x 1024] of dhidden,
// is 512 fp32 a thread over one warpgroup: registers decide the split of Hh.
// A warpgroup owns 64 rows x 256 columns (128 registers), so a 2-block cluster
// of 8 warps each (no producer warp: 9 or 12 warps cap a thread at 168
// registers, see dw2) owns (k, 64 rows), each warpgroup a quarter of Hh. The
// logits need all of Hh: each warpgroup reduces its quarter (m64n32k16 on its
// resident [64, 256] of hidden and a [32, 256] tile of w2t), and the four fp32
// partials meet in each block's shared memory (the other block's arrive by
// st.async, counted in bytes on the receiving block's barrier), summed in one
// fixed order by all four, so their dlogits are bit-identical and nothing is
// recomputed: the kernel does the two products of the bound. exp, the
// one-hot, g and the bf16 rounding act on the accumulator in registers, whose
// layout is that of the A fragments of the second product (the P.V hand-over
// of the flash forward): dhidden += dlogits . tile reads the same w2t boxes
// again as an MN-major B (m64n128k16, A from registers). Up to Hh = 512 one
// block's two warpgroups cover Hh and the partials stay in its shared memory.
// Each warpgroup keeps a ring of 4 w2t tiles (16 KB each at Hh = 1024) that
// one of its threads refills, and puts the next tile's logits on the tensor
// cores before it sums this tile's partials. What bounds it: the exchange
// synchronises the cluster's four warpgroups once a tile, and the n = 32
// logits product reads 3 KB of shared memory for 32 K multiply-adds, more
// than shared memory feeds at the tensor cores' rate. Through L2 go
// 1,656 blocks x 2.1 MB of w2t = 3.5 GB a call at the training shape; a
// cluster that multicasts a w2t tile to two row blocks would halve that.
//
// Every mbarrier wait is bounded (hopper_tma_wgmma.cuh): a fault traps instead
// of hanging the device. Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma_wgmma.cuh"
#include "mma_fragments.cuh"

namespace {

using namespace ssr;
using namespace ssr::sm90;

constexpr int kMaxHh = 1024;

// ------------------------------------------------------------------ forward

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kChunk = 64;  // Hh columns of one TMA box: 128 bytes, the swizzle width

// 2^x on the special-function unit in one instruction (2 ulp; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// sum += a . b over the 8 bf16 pairs of a 16-byte chunk, in order
__device__ __forceinline__ float dot8(float sum, const uint4& a, const uint4& b) {
  sum = fmaf(bf16_lo(a.x), bf16_lo(b.x), sum);
  sum = fmaf(bf16_hi(a.x), bf16_hi(b.x), sum);
  sum = fmaf(bf16_lo(a.y), bf16_lo(b.y), sum);
  sum = fmaf(bf16_hi(a.y), bf16_hi(b.y), sum);
  sum = fmaf(bf16_lo(a.z), bf16_lo(b.z), sum);
  sum = fmaf(bf16_hi(a.z), bf16_hi(b.z), sum);
  sum = fmaf(bf16_lo(a.w), bf16_lo(b.w), sum);
  sum = fmaf(bf16_hi(a.w), bf16_hi(b.w), sum);
  return sum;
}

// one consumer warp is done reading a stage
__device__ __forceinline__ void release_stage(uint32_t empty_bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty_bar);
}

// The pre-pass: tlogit[k, n] = hidden[k, n, :] . w2t[k, t, :] + b2[k, t] in
// fp32, a warp a row (-inf for a target outside [0, C)).
constexpr int kTlThreads = 256;

__global__ void __launch_bounds__(kTlThreads)
ce_target_logit_kernel(const uint16_t* __restrict__ hidden, const uint16_t* __restrict__ w2t,
                       const uint16_t* __restrict__ b2, const int* __restrict__ targets,
                       float* __restrict__ tlogit, int rows, int N, int Hh, int C) {
  const int row = blockIdx.x * (kTlThreads / 32) + (threadIdx.x >> 5);  // k * N + n
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int k = row / N;
  const int t = targets[row];
  const bool ok = t >= 0 && t < C;
  float sum = 0.f;
  if (ok) {
    const uint4* h = reinterpret_cast<const uint4*>(hidden + static_cast<size_t>(row) * Hh);
    const uint4* w =
        reinterpret_cast<const uint4*>(w2t + (static_cast<size_t>(k) * C + t) * Hh);
    for (int i = lane; i < Hh / 8; i += 32) sum = dot8(sum, h[i], w[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    tlogit[row] = ok ? sum + bf16_float(b2[static_cast<size_t>(k) * C + t]) : -INFINITY;
  }
}

constexpr int kFwdRows = 128;     // rows a block: 64 a consumer warpgroup
constexpr int kFwdVt = 128;       // vocab columns a tile
constexpr int kFwdTail = 8;       // a last tile this narrow is one m64n8 product
constexpr int kFwdStages = 6;
constexpr int kFwdThreads = 384;  // two consumer warpgroups, the producer's warpgroup
constexpr int kFwdBoxBytes = 128 * kChunk * 2;    // [128 x 64] bf16: 16 KB
constexpr int kFwdStageBytes = 2 * kFwdBoxBytes;  // a chunk of hidden, a chunk of w2t
constexpr int kFwdOffBar = kFwdStages * kFwdStageBytes;  // full[], empty[]
constexpr size_t kFwdSmem = 1024 + kFwdOffBar + 8 * 2 * kFwdStages;

// One row's running statistics in one thread of its quad.
struct FwdRow {
  float m;     // running max (the quad's)
  float l;     // this thread's part of sum exp(x - m)
  float tl;    // the target's logit as the pass computed it (-inf in the other threads)
  float tlog;  // the target's logit from the pre-pass
  int cnt;     // this thread's part of #(x > tlog) over the other columns
  int t;
};

// A tile's columns of one row: acc[4j + kOff + e] is column col0 + 8j + e.
template <int NJ, int kOff>
__device__ __forceinline__ void fwd_row_update(const float (&acc)[4 * NJ], int col0, FwdRow& r) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j + kOff], acc[4 * j + kOff + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(r.m, mx);
  // exp(x - m) = 2^(x log2e - m log2e): one multiply-add and one ex2
  const float nb = m_new == -INFINITY ? 0.f : -m_new * kLog2e;
  r.l *= fast_exp2(fmaf(r.m, kLog2e, nb));
  r.m = m_new;
  float l = 0.f;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = acc[4 * j + kOff + e];
      l += fast_exp2(fmaf(x, kLog2e, nb));
      const int above = x > r.tlog ? 1 : 0;
      cnt += above;
      if (col0 + 8 * j + e == r.t) {  // the target's own column does not count
        r.tl = x;
        cnt -= above;
      }
    }
  }
  r.l += l;
  r.cnt += cnt;
}

// What a consumer warpgroup of the forward knows about its walk.
struct FwdWalk {
  uint32_t base, full_bar, empty_bar;
  uint32_t a_off;  // this warpgroup's 64 rows inside a stage's chunk of hidden
  int nch;         // chunks of 64 along Hh
  int stage;
  uint32_t parity;
};

// One vocab tile of 8 NJ columns from v0: the accumulator starts as the bias
// (-inf past C, where w2t's rows arrive as zeros, so the mask is free), takes
// 4 wgmma a chunk as the chunks land, and is reduced into the rows' statistics.
template <int NJ>
__device__ __forceinline__ void fwd_tile(FwdWalk& w, const uint16_t* __restrict__ b2k, int v0,
                                         int C, int lane, FwdRow& ra, FwdRow& rb) {
  const int col0 = v0 + (lane & 3) * 2;
  float acc[4 * NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = col0 + 8 * j;
    const float b0 = c < C ? bf16_float(b2k[c]) : -INFINITY;
    const float b1 = c + 1 < C ? bf16_float(b2k[c + 1]) : -INFINITY;
    acc[4 * j] = acc[4 * j + 2] = b0;
    acc[4 * j + 1] = acc[4 * j + 3] = b1;
  }
  wgmma_fence();
  uint32_t prev_empty = 0;
  for (int c = 0; c < w.nch; ++c) {
    mbar_wait(w.full_bar + 8 * w.stage, w.parity);
    const uint32_t st = w.base + w.stage * kFwdStageBytes;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint64_t da = desc_kmajor_box(st + w.a_off, kk);
      const uint64_t db = desc_kmajor_box(st + kFwdBoxBytes, kk);
      if constexpr (NJ == 16) {
        wgmma_m64n128k16_ss(acc, da, db, 1);
      } else {
        wgmma_m64n8k16_ss(acc, da, db, 1);
      }
    }
    wgmma_commit();
    if (c > 0) {  // the chunk before this one has been read
      wgmma_wait<1>();
      release_stage(prev_empty, lane);
    }
    prev_empty = w.empty_bar + 8 * w.stage;
    if (++w.stage == kFwdStages) {
      w.stage = 0;
      w.parity ^= 1;
    }
  }
  wgmma_wait<0>();
  release_stage(prev_empty, lane);
  fence_operands(acc);
  fwd_row_update<NJ, 0>(acc, col0, ra);
  fwd_row_update<NJ, 2>(acc, col0, rb);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the quad's statistics of one row, written by its first thread
__device__ __forceinline__ void fwd_store_row(FwdRow& r, bool writer, size_t o,
                                              float* __restrict__ nll, float* __restrict__ logz,
                                              float* __restrict__ hits, int top) {
  const float l = quad_sum(r.l);
  int cnt = r.cnt;
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
  float tl = fmaxf(r.tl, __shfl_xor_sync(0xffffffffu, r.tl, 1));
  tl = fmaxf(tl, __shfl_xor_sync(0xffffffffu, tl, 2));
  if (writer) {
    const float z = r.m + log2f(l) * kLn2;
    logz[o] = z;
    nll[o] = z - tl;
    hits[o] = cnt < top ? 1.f : 0.f;
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
ce_fwd_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
              const uint16_t* __restrict__ b2, const int* __restrict__ targets,
              const float* __restrict__ tlogit, float* __restrict__ nll,
              float* __restrict__ logz, float* __restrict__ hits, int N, int Hh, int C, int top) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + kFwdOffBar;
  const uint32_t empty_bar = full_bar + 8 * kFwdStages;

  const int k = blockIdx.y;
  const int row0 = blockIdx.x * kFwdRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nch = Hh / kChunk;
  const int ntiles = (C + kFwdVt - 1) / kFwdVt;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the TMA request
      mbar_init(empty_bar + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
    tma_prefetch_map(&hmap);
    tma_prefetch_map(&wmap);
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (tid >= 256 + 32) return;
    int stage = 0;
    uint32_t parity = 1;  // the ring starts empty
    for (int vt = 0; vt < ntiles; ++vt) {
      for (int c = 0; c < nch; ++c) {
        mbar_wait(empty_bar + 8 * stage, parity);
        if (lane == 0) {
          const uint32_t bar = full_bar + 8 * stage;
          const uint32_t dst = base + stage * kFwdStageBytes;
          mbar_arrive_expect_tx(bar, kFwdStageBytes);
          tma_load_3d(dst, &hmap, bar, c * kChunk, row0, k);
          tma_load_3d(dst + kFwdBoxBytes, &wmap, bar, c * kChunk, vt * kFwdVt, k);
        }
        if (++stage == kFwdStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const size_t kn = static_cast<size_t>(k) * N;
    const int row_a = row0 + role * 64 + warp * 16 + g;  // this thread's two rows
    const int row_b = row_a + 8;
    const bool in_a = row_a < N;
    const bool in_b = row_b < N;
    FwdRow ra = {-INFINITY, 0.f, -INFINITY, in_a ? tlogit[kn + row_a] : 0.f, 0,
                 in_a ? targets[kn + row_a] : -1};
    FwdRow rb = {-INFINITY, 0.f, -INFINITY, in_b ? tlogit[kn + row_b] : 0.f, 0,
                 in_b ? targets[kn + row_b] : -1};
    const uint16_t* b2k = b2 + static_cast<size_t>(k) * C;
    FwdWalk walk = {base, full_bar, empty_bar, static_cast<uint32_t>(role) * 64 * 128, nch, 0, 0};
    for (int vt = 0; vt < ntiles; ++vt) {
      const int v0 = vt * kFwdVt;
      if (C - v0 > kFwdTail) {
        fwd_tile<kFwdVt / 8>(walk, b2k, v0, C, lane, ra, rb);
      } else {
        fwd_tile<kFwdTail / 8>(walk, b2k, v0, C, lane, ra, rb);
      }
    }
    const bool first = (lane & 3) == 0;
    fwd_store_row(ra, first && in_a, kn + row_a, nll, logz, hits, top);
    fwd_store_row(rb, first && in_b, kn + row_b, nll, logz, hits, top);
  }
}

// ------------------------------------------------------------------ dhidden

constexpr int kDhRows = 64;      // rows of a block, and of its cluster
constexpr int kDhVt = 32;        // vocab rows of w2t a tile
constexpr int kDhTail = 8;       // a last tile this narrow is one m64n8 product
constexpr int kDhStages = 4;     // w2t tiles a warpgroup keeps in flight
constexpr int kDhThreads = 256;  // two warpgroups, no producer warp
constexpr int kDhMaxQ = 4;       // chunks of 64 columns of Hh a warpgroup owns, at most
constexpr int kDhHBoxBytes = kDhRows * kChunk * 2;  // [64 rows x 64 columns] of hidden: 8 KB
constexpr int kDhWBoxBytes = kDhVt * kChunk * 2;    // [32 vocab rows x 64 columns] of w2t: 4 KB
constexpr int kDhSlotBytes = kDhRows * kDhVt * 4;   // a warpgroup's partial logits, fp32: 8 KB
constexpr int kDhRecvBytes = 4 * kDhSlotBytes;      // the cluster's four partials of a tile
constexpr int kDhRemoteBytes = 2 * kDhSlotBytes;    // those of them the other block sends
// shared memory, from a 1024-byte boundary: each warpgroup's hidden boxes,
// each warpgroup's ring of w2t stages, the partial logits of one tile [4
// warpgroups of the cluster], then the barriers
constexpr int kDhOffH = 0;
constexpr int kDhOffRing = kDhOffH + 2 * kDhMaxQ * kDhHBoxBytes;
constexpr int kDhOffRecv = kDhOffRing + 2 * kDhStages * kDhMaxQ * kDhWBoxBytes;
constexpr int kDhOffBar = kDhOffRecv + kDhRecvBytes;
// barriers: hidden[2], full[2][kDhStages], recv, done
constexpr size_t kDhSmem = 1024 + kDhOffBar + 8 * (2 + 2 * kDhStages + 2);
static_assert(kDhOffRing % 1024 == 0 && kDhOffRecv % 1024 == 0, "tiles on 1024-byte boundaries");
static_assert(kDhSmem <= 232448, "one block's shared memory on sm_90");

// A warpgroup's dhidden accumulator, [64 rows x 64 kQ columns]: pairs of
// chunks as m64n128 products, the last chunk of an odd kQ as an m64n64 one.
template <int kQ>
struct DhAcc {
  float p[kQ / 2 > 0 ? kQ / 2 : 1][64];
  float s[32];
};

// The partial logits of one vocab tile over this warpgroup's chunks of Hh,
// [64 rows x 32 columns] (x 8 for the narrow tail): hidden and the stage's
// w2t boxes, both with Hh contiguous. Issued and committed, not waited for.
template <int kQ, bool kNarrow>
__device__ __forceinline__ void dh_logits(float (&lg)[16], uint32_t hs, uint32_t stage) {
  // the first step's descriptors, the others a constant further; made anew
  // for every tile: hoisted out of the tile loop, the 16 of hidden would hold
  // 32 registers the accumulators need
  uint64_t d_h = desc_kmajor_box(hs, 0);
  uint64_t d_w = desc_kmajor_box(stage, 0);
  asm volatile("" : "+l"(d_h), "+l"(d_w));
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint64_t da = d_h + desc_step(q * kDhHBoxBytes + kk * 32);
      const uint64_t db = d_w + desc_step(q * kDhWBoxBytes + kk * 32);
      if constexpr (kNarrow) {
        wgmma_m64n8k16_ss(lg, da, db, (q | kk) != 0);
      } else {
        wgmma_m64n32k16_ss<0, 0>(lg, da, db, (q | kk) != 0);
      }
    }
  }
  wgmma_commit();
}

// dhidden += dlogits . w2t tile over kSteps 16-deep steps of the tile's vocab
// rows: the dlogits from registers, the same w2t boxes as the logits read,
// now with the vocab rows as the reduction (trans-b). Issued and committed.
template <int kQ, int kSteps>
__device__ __forceinline__ void dh_product(DhAcc<kQ>& acc, const uint32_t (&a)[2][4],
                                           uint32_t stage) {
  uint64_t d_b = desc_mnmajor(stage, kDhVt, 0);
  asm volatile("" : "+l"(d_b));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int p = 0; p < kQ / 2; ++p) {
      wgmma_m64n128k16_rs_tb(acc.p[p], a[kk],
                             d_b + desc_step(2 * p * kDhWBoxBytes + kk * 2 * kSwizzleAtomBytes));
    }
    if constexpr (kQ % 2 == 1) {
      wgmma_m64n64k16_rs_tb(acc.s, a[kk],
                            d_b + desc_step((kQ - 1) * kDhWBoxBytes + kk * 2 * kSwizzleAtomBytes));
    }
  }
  wgmma_commit();
}

// ce_dhidden_kernel<kQ, kCS>: a cluster of kCS blocks owns (k, 64 rows); its
// 2 kCS warpgroups split Hh, warpgroup q = 2 rank + w owning chunks
// [q kQ, q kQ + kQ) of 64 columns (chunks past Hh arrive as zeros and are not
// stored). For each vocab tile of 32 rows of w2t (a ring of kDhStages tiles a
// warpgroup, refilled by one thread of it):
//   1. the partial logits over its chunks (m64n32k16, 4 kQ steps) into its
//      slot of its own block (stores, then an arrival a warp) and of the
//      other block (st.async, whose bytes that block's barrier counts: no
//      fence on either side);
//   2. the 2 kCS partials summed in the order q = 0, 1, ... by every
//      warpgroup from its own shared memory, so that all of them hold
//      bit-identical logits; the bias, exp, one-hot and g in registers;
//      rounded to bf16 straight into A fragments;
//   3. dhidden[64, its columns] += dlogits . tile, the same w2t boxes as B.
// The next tile's logits run on the tensor cores while this tile's partials
// are summed and its dlogits formed. A slot is written again only after every
// warp of the cluster has arrived on each block's done barrier. No atomics:
// bit-reproducible.
template <int kQ, int kCS>
__global__ void __launch_bounds__(kDhThreads, 1)
ce_dhidden_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                  const uint16_t* __restrict__ b2, const int* __restrict__ targets,
                  const float* __restrict__ logz, const float* __restrict__ gin,
                  uint16_t* __restrict__ dhidden, int N, int Hh, int C) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t h_bar = base + kDhOffBar;
  const uint32_t full_bar = h_bar + 16;
  const uint32_t recv_bar = full_bar + 16 * kDhStages;
  const uint32_t done_bar = recv_bar + 8;
  constexpr int kStageBytes = kQ * kDhWBoxBytes;  // a warpgroup's w2t stage

  const int k = blockIdx.y;
  const uint32_t rank = kCS == 2 ? cluster_rank() : 0;
  const int row0 = (blockIdx.x / kCS) * kDhRows;
  const int tid = threadIdx.x;
  const int w = warpgroup_index();
  const int tig = tid & 127;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q_me = 2 * static_cast<int>(rank) + w;
  const int col0 = q_me * kQ * kChunk;  // this warpgroup's columns of Hh
  const int ntiles = (C + kDhVt - 1) / kDhVt;
  const uint32_t hs = base + kDhOffH + w * kDhMaxQ * kDhHBoxBytes;
  const uint32_t ring = base + kDhOffRing + w * kDhStages * kDhMaxQ * kDhWBoxBytes;
  const uint32_t full_w = full_bar + 8 * kDhStages * w;

  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * kDhStages; ++i) mbar_init(h_bar + 8 * i, 1);  // TMA requests
    mbar_init(recv_bar, kCS == 2 ? 9 : 8);  // a warp of the block (+ the bytes' arming)
    mbar_init(done_bar, 8 * kCS);           // a warp of the cluster
    mbar_fence_init();
    if constexpr (kCS == 2) mbar_arrive_expect_tx(recv_bar, kDhRemoteBytes);
    tma_prefetch_map(&hmap);
    tma_prefetch_map(&wmap);
  }
  __syncthreads();
  if constexpr (kCS == 2) cluster_sync();

  // tile t of w2t (its 32 vocab rows, this warpgroup's chunks) into stage t % kDhStages
  auto load_tile = [&](int t) {
    const uint32_t bar = full_w + 8 * (t % kDhStages);
    const uint32_t dst = ring + (t % kDhStages) * kStageBytes;
    mbar_arrive_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      tma_load_3d(dst + q * kDhWBoxBytes, &wmap, bar, col0 + q * kChunk, t * kDhVt, k);
    }
  };
  if (tig == 0) {
    mbar_arrive_expect_tx(h_bar + 8 * w, kQ * kDhHBoxBytes);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      tma_load_3d(hs + q * kDhHBoxBytes, &hmap, h_bar + 8 * w, col0 + q * kChunk, row0, k);
    }
    for (int t = 0; t < kDhStages && t < ntiles; ++t) load_tile(t);
  }

  // this thread's two rows; rows past N: g = 0, so dlogits = 0
  const size_t kn = static_cast<size_t>(k) * N;
  const int row_a = row0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bool in_a = row_a < N;
  const bool in_b = row_b < N;
  const int t_a = in_a ? targets[kn + row_a] : -1;
  const int t_b = in_b ? targets[kn + row_b] : -1;
  const float z_a = in_a ? logz[kn + row_a] * kLog2e : 0.f;
  const float z_b = in_b ? logz[kn + row_b] * kLog2e : 0.f;
  const float g_a = in_a ? gin[kn + row_a] : 0.f;
  const float g_b = in_b ? gin[kn + row_b] : 0.f;
  const uint16_t* b2k = b2 + static_cast<size_t>(k) * C;

  // Partials of a tile: slot q, 4 float4 a thread (the thread's 16 logits in
  // accumulator order, 2 KB apart). The recv and done barriers complete once
  // a tile: tile t is their phase t.
  auto recv_slot = [&](int q) -> uint32_t {
    return base + kDhOffRecv + q * kDhSlotBytes + tig * 16;
  };
  // this warpgroup's partial of tile t into slot q_me of every block, once
  // every warp of the cluster has read the slots' tile t - 1
  auto publish = [&](const float (&lg)[16], int t) {
    if (t > 0) mbar_wait(done_bar, (t - 1) & 1);
    const uint32_t dst = recv_slot(q_me);
    if constexpr (kCS == 2) {
      const uint32_t rd = mapa_shared(dst, rank ^ 1u);
      const uint32_t rb = mapa_shared(recv_bar, rank ^ 1u);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        st_async_f32x4(rd + ii * 2048, lg[4 * ii], lg[4 * ii + 1], lg[4 * ii + 2],
                       lg[4 * ii + 3], rb);
      }
    }
    float4* own = reinterpret_cast<float4*>(gen + (dst - base));
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      own[ii * 128] = make_float4(lg[4 * ii], lg[4 * ii + 1], lg[4 * ii + 2], lg[4 * ii + 3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(recv_bar);
  };

  float lg[16];
  uint32_t a[2][4] = {};  // the dlogits of the tile in its second product, A fragments
  DhAcc<kQ> acc;
#pragma unroll
  for (int p = 0; p < kQ / 2; ++p)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc.p[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc.s[i] = 0.f;

  mbar_wait(h_bar + 8 * w, 0);
  mbar_wait(full_w, 0);
  if (C > kDhTail) {
    dh_logits<kQ, false>(lg, hs, ring);
  } else {
    dh_logits<kQ, true>(lg, hs, ring);
  }
  wgmma_wait<0>();
  fence_operands(lg);
  publish(lg, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int v0 = i * kDhVt;
    const bool more = i + 1 < ntiles;
    // the bias of this thread's columns v0 + 8j + 2t4 + {0, 1} as bf16 pairs,
    // asked for first: an L2 read whose latency the steps before its use cover
    uint32_t bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + 8 * j + 2 * t4;
      const uint32_t lo = col < C ? b2k[col] : 0u;
      const uint32_t hi = col + 1 < C ? b2k[col + 1] : 0u;
      bias[j] = lo | (hi << 16);
    }
    // 1. the next tile's logits go to the tensor cores behind tile i - 1's
    //    second product (lg is free: tile i's partial is published)
    if (more) {
      const int t = i + 1;
      mbar_wait(full_w + 8 * (t % kDhStages), (t / kDhStages) & 1);
      const uint32_t st = ring + (t % kDhStages) * kStageBytes;
      if (C - t * kDhVt > kDhTail) {
        dh_logits<kQ, false>(lg, hs, st);
      } else {
        dh_logits<kQ, true>(lg, hs, st);
      }
    }
    // 2. tile i - 1's second product is done: its stage takes tile i - 1 + kDhStages
    if (i > 0) {
      if (more) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operands(a[0]);
      fence_operands(a[1]);
      warpgroup_barrier(w);
      if (tig == 0 && i - 1 + kDhStages < ntiles) load_tile(i - 1 + kDhStages);
    }
    // 3. the logits of tile i, the partials summed in the fixed order q = 0,
    //    1, ..., and at once dlogits = bf16((exp(logit - logz) - onehot) * g)
    //    as the A fragments of the second product: 8-column block j holds
    //    row a, columns 8j + 2t4 + {0, 1}, and row b, the same columns
    mbar_wait(recv_bar, i & 1);
    const float4* part = reinterpret_cast<const float4*>(gen + (recv_slot(0) - base));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 x = part[j * 128];
#pragma unroll
      for (int q = 1; q < 2 * kCS; ++q) {
        const float4 v = part[q * (kDhSlotBytes / 16) + j * 128];
        x.x += v.x, x.y += v.y, x.z += v.z, x.w += v.w;
      }
      const int col = v0 + 8 * j + 2 * t4;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (col < C) {
        const float b = bf16_lo(bias[j]);
        d[0] = (fast_exp2((x.x + b) * kLog2e - z_a) - (col == t_a ? 1.f : 0.f)) * g_a;
        d[2] = (fast_exp2((x.z + b) * kLog2e - z_b) - (col == t_b ? 1.f : 0.f)) * g_b;
      }
      if (col + 1 < C) {
        const float b = bf16_hi(bias[j]);
        d[1] = (fast_exp2((x.y + b) * kLog2e - z_a) - (col + 1 == t_a ? 1.f : 0.f)) * g_a;
        d[3] = (fast_exp2((x.w + b) * kLog2e - z_b) - (col + 1 == t_b ? 1.f : 0.f)) * g_b;
      }
      a[j >> 1][2 * (j & 1)] = pack_bf16(d[0], d[1]);
      a[j >> 1][2 * (j & 1) + 1] = pack_bf16(d[2], d[3]);
    }
    // 4. every warp of the cluster is done with tile i's partials: the
    //    arrival comes after the arithmetic that consumed the loads, so they
    //    have completed before another block may overwrite the slots
    __syncwarp();
    if (lane == 0) {
      if constexpr (kCS == 2) {
        mbar_arrive_remote(done_bar, 0);
        mbar_arrive_remote(done_bar, 1);
      } else {
        mbar_arrive(done_bar);
      }
    }
    if constexpr (kCS == 2) {
      // the barrier's next phase (tile i + 1) expects its bytes
      if (tid == 0 && i + 1 < ntiles) mbar_arrive_expect_tx(recv_bar, kDhRemoteBytes);
    }
    // 5. dhidden += dlogits . w2t tile, behind the next tile's logits
    const uint32_t st = ring + (i % kDhStages) * kStageBytes;
    if (C - v0 > kDhTail) {
      dh_product<kQ, 2>(acc, a, st);
    } else {
      dh_product<kQ, 1>(acc, a, st);
    }
    // 6. the next tile's partial out to the cluster
    if (more) {
      wgmma_wait<1>();
      fence_operands(lg);
      publish(lg, i + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < kQ / 2; ++p) fence_operands(acc.p[p]);
  fence_operands(acc.s);
  // no block leaves while another may still arrive on its barriers: the last
  // tile's done phase has every warp's arrival
  if constexpr (kCS == 2) mbar_wait(done_bar, (ntiles - 1) & 1);

  // rows a and b, columns 8j + 2t4 + {0, 1} of each chunk pair / last chunk
  uint16_t* out = dhidden + kn * Hh;
  auto store = [&](float v0, float v1, float v2, float v3, int c) {
    if (c < Hh) {
      if (in_a) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_a) * Hh + c) = pack_bf16(v0, v1);
      }
      if (in_b) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_b) * Hh + c) = pack_bf16(v2, v3);
      }
    }
  };
#pragma unroll
  for (int p = 0; p < kQ / 2; ++p) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      store(acc.p[p][4 * j], acc.p[p][4 * j + 1], acc.p[p][4 * j + 2], acc.p[p][4 * j + 3],
            col0 + 2 * p * kChunk + 8 * j + 2 * t4);
    }
  }
  if constexpr (kQ % 2 == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store(acc.s[4 * j], acc.s[4 * j + 1], acc.s[4 * j + 2], acc.s[4 * j + 3],
            col0 + (kQ - 1) * kChunk + 8 * j + 2 * t4);
    }
  }
}

// ------------------------------------------------------------------ dw2, db2

constexpr int kDwRows = 64;       // rows of a row block
constexpr int kDwVt = 32;         // vocab columns a block
constexpr int kDwThreads = 256;   // two warpgroups, 2 warps a scheduler: 255 registers a thread
constexpr int kDwChunkBytes = kDwRows * kChunk * 2;  // [64 rows x 64 columns] of hidden: 8 KB
constexpr int kDwWBoxBytes = kDwVt * kChunk * 2;     // [32 columns of C x 64 of Hh] of w2t: 4 KB
constexpr int kDwMaxHalf = kMaxHh / (2 * kChunk);    // chunks of Hh a warpgroup: 8
// shared memory, from a 1024-byte boundary
constexpr int kDwOffW = 0;                                         // the w2t tile, a box a chunk
constexpr int kDwOffDl = kDwOffW + 2 * kDwMaxHalf * kDwWBoxBytes;  // dlogits^T [32 x 64] bf16
constexpr int kDwOffPart = kDwOffDl + kDwVt * kDwRows * 2;         // warpgroup: 8 x 128 fp32
constexpr int kDwOffRing = kDwOffPart + 2 * 8 * 128 * 4;           // warpgroup: its chunks
constexpr int kDwOffDb = kDwOffRing + 2 * kDwMaxHalf * kDwChunkBytes;  // db2: 8 x 32 partial sums
constexpr int kDwOffBar = kDwOffDb + 8 * kDwVt * 4;
// barriers: w, part, dl, full[2][chunks]
constexpr size_t kDwSmem = 1024 + kDwOffBar + 8 * (3 + 2 * kDwMaxHalf);
static_assert(kDwOffRing % 1024 == 0, "swizzled tiles start on 1024-byte boundaries");
static_assert(kDwSmem <= 232448, "one block's shared memory on sm_90");

// Chunk jj of warpgroup w's half of Hh, rows of row block rb, into the
// warpgroup's slot jj, by one thread.
__device__ __forceinline__ void dw2_load_chunk(uint32_t ring, uint32_t full_w,
                                               const CUtensorMap* hmap, int col0, int jj, int rb,
                                               int k) {
  mbar_arrive_expect_tx(full_w + 8 * jj, kDwChunkBytes);
  tma_load_3d(ring + jj * kDwChunkBytes, hmap, full_w + 8 * jj, col0 + jj * kChunk, rb * kDwRows,
              k);
}

// A warpgroup of the dw2/db2 kernel: warpgroup w reduces its half of Hh for the
// logits, finishes its half of the dlogits tile's columns (0-15 or 16-31) and
// owns its half of dw2's rows: kHalf = Hh / 128 chunks of 64, each with a slot
// of its own that one thread of the warpgroup refills for the next row block
// as soon as the second product has read it. There is no producer warp: a
// ninth warp would make three on one scheduler, and ptxas then allows 168
// registers a thread, spills and serialises every wgmma (its note C7512); the
// 128 registers of dw2 leave room for little else. kHalf is a template
// parameter because a wgmma under a run-time condition has the same effect.
template <int kHalf>
__device__ __forceinline__ void dw2_consume(
    uint32_t base, unsigned char* gen, const CUtensorMap* hmap, uint32_t w_bar,
    uint32_t part_bar, uint32_t dl_bar, uint32_t full_bar, const uint16_t* __restrict__ b2k,
    const int* __restrict__ targets, const float* __restrict__ logz,
    const float* __restrict__ gin, float* __restrict__ dw2k, float* __restrict__ db2k, int w,
    int k, int v0, int N, int C) {
  const int tid = threadIdx.x;  // < 256
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int tig = tid & 127;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int nrb = (N + kDwRows - 1) / kDwRows;
  const uint32_t ring = base + kDwOffRing + w * kDwMaxHalf * kDwChunkBytes;
  const uint32_t full_w = full_bar + 8 * w * kDwMaxHalf;
  const int col0 = w * kHalf * kChunk;  // this half's columns of hidden
  const uint32_t wt = base + kDwOffW + w * kHalf * kDwWBoxBytes;  // this half's boxes of w2t
  const uint32_t dl_s = base + kDwOffDl;
  unsigned char* dl_g = gen + kDwOffDl;
  // Thread t of either warpgroup holds the same elements of the logits tile:
  // rows n_a = 16 warp + g and n_a + 8, columns 8j + 2t4 + e. It hands the
  // columns it does not finish (j = 2, 3 for w = 0; j = 0, 1 for w = 1) to
  // thread t of the other warpgroup.
  float* part_out = reinterpret_cast<float*>(gen + kDwOffPart) + w * 8 * 128 + tig;
  const float* part_in = reinterpret_cast<float*>(gen + kDwOffPart) + (1 - w) * 8 * 128 + tig;
  const int n_a = warp * 16 + g;
  const int n_b = n_a + 8;
  const int vl0 = 16 * w + 2 * t4;  // this thread's columns of the tile: vl0 + 8jj + e
  // column vl0 + 8jj + e lies 8jj rows of 128 bytes past column vl0 + e (the
  // swizzle looks at the row's index mod 8 only)
  unsigned char* dl_a[2] = {dl_g + swizzle128_offset(vl0, n_a),
                            dl_g + swizzle128_offset(vl0 + 1, n_a)};
  unsigned char* dl_b[2] = {dl_g + swizzle128_offset(vl0, n_b),
                            dl_g + swizzle128_offset(vl0 + 1, n_b)};
  float bias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = v0 + vl0 + 8 * (i >> 1) + (i & 1);
    bias[i] = col < C ? bf16_float(b2k[col]) : 0.f;
  }

  float acc[kHalf][16];  // dw2 rows 64 (w half + jj) + ..., this block's 32 columns
#pragma unroll
  for (int jj = 0; jj < kHalf; ++jj)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[jj][i] = 0.f;
  float dbp = 0.f;  // db2: column tid % 32, rows 8 (tid / 32) + ... of every block

  if (tig == 0) {
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) dw2_load_chunk(ring, full_w, hmap, col0, jj, 0, k);
  }
  mbar_wait(w_bar, 0);
  for (int rb = 0; rb < nrb; ++rb) {
    const uint32_t xpar = rb & 1;
    // this thread's two rows of the block; rows past N: g = 0, so dlogits = 0
    const int row_a = rb * kDwRows + n_a;
    const int row_b = row_a + 8;
    const bool in_a = row_a < N;
    const bool in_b = row_b < N;
    const int t_a = in_a ? targets[row_a] : -1;
    const int t_b = in_b ? targets[row_b] : -1;
    const float z_a = in_a ? logz[row_a] * kLog2e : 0.f;
    const float z_b = in_b ? logz[row_b] * kLog2e : 0.f;
    const float g_a = in_a ? gin[row_a] : 0.f;
    const float g_b = in_b ? gin[row_b] : 0.f;

    // The operands that stay put, as descriptors of their first k step; the
    // others are a constant further (desc_step). Re-made for every row block:
    // hoisted out of the loop, the 128 distinct descriptors would take the
    // registers the accumulators need.
    uint64_t d_wt = desc_kmajor_box(wt, 0);
    uint64_t d_dl = desc_kmajor_box(dl_s, 0);
    uint64_t d_k = desc_kmajor_box(ring, 0);    // the chunks as the logits' A operand
    uint64_t d_mn = desc_mnmajor_a64(ring, 0);  // and as dw2's, through the transpose bit
    asm volatile("" : "+l"(d_wt), "+l"(d_dl), "+l"(d_k), "+l"(d_mn));

    // logits [64, 32], this warpgroup's half of the reduction over Hh
    float lg[16];
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      mbar_wait(full_w + 8 * jj, xpar);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        wgmma_m64n32k16_ss<0, 0>(lg, d_k + desc_step(jj * kDwChunkBytes + kk * 32),
                                 d_wt + desc_step(jj * kDwWBoxBytes + kk * 32), (jj | kk) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(lg);

    // swap halves: lg[0..7] are columns 0-15 of the tile, lg[8..15] 16-31
#pragma unroll
    for (int i = 0; i < 8; ++i) part_out[i * 128] = w == 0 ? lg[8 + i] : lg[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(part_bar);
    mbar_wait(part_bar, xpar);
    // dlogits = bf16((exp(logit - logz) - onehot) * g), stored transposed
    // ([column][row], the rows contiguous: the second product's B operand with
    // its reduction dimension contiguous) in the 128-byte swizzle
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + vl0 + 8 * jj + e;
        const int i = 4 * jj + e;  // of this warpgroup's 8 accumulators a row pair
        float d_a = 0.f, d_b = 0.f;
        if (col < C) {
          const float own_a = w == 0 ? lg[i] : lg[8 + i];
          const float own_b = w == 0 ? lg[i + 2] : lg[8 + i + 2];
          const float x_a = ((own_a + part_in[i * 128]) + bias[2 * jj + e]) * kLog2e;
          const float x_b = ((own_b + part_in[(i + 2) * 128]) + bias[2 * jj + e]) * kLog2e;
          d_a = (fast_exp2(x_a - z_a) - (col == t_a ? 1.f : 0.f)) * g_a;
          d_b = (fast_exp2(x_b - z_b) - (col == t_b ? 1.f : 0.f)) * g_b;
        }
        *reinterpret_cast<uint16_t*>(dl_a[e] + jj * 8 * 128) = bf16_bits(d_a);
        *reinterpret_cast<uint16_t*>(dl_b[e] + jj * 8 * 128) = bf16_bits(d_b);
      }
    }
    fence_proxy_async();  // the wgmmas below, of both warpgroups, read these stores
    __syncwarp();
    if (lane == 0) mbar_arrive(dl_bar);
    mbar_wait(dl_bar, xpar);

    // dw2[64 rows of Hh a chunk, 32] += hidden^T . dlogits over the block's 64
    // rows; a chunk's slot is refilled as soon as its product has read it
    const bool refill = tig == 0 && rb + 1 < nrb;
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
#pragma unroll
      for (int kk = 0; kk < kDwRows / 16; ++kk) {
        wgmma_m64n32k16_ss<1, 0>(
            acc[jj], d_mn + desc_step(jj * kDwChunkBytes + kk * 2 * kSwizzleAtomBytes),
            d_dl + desc_step(kk * 32), 1);
      }
      wgmma_commit();
      if (jj > 0) {
        wgmma_wait<1>();
        warpgroup_barrier(w);  // every warp's product has read chunk jj - 1
        if (refill) dw2_load_chunk(ring, full_w, hmap, col0, jj - 1, rb + 1, k);
      }
    }
    {
      // db2: 8 rows of this thread's column (one 16-byte chunk), in row order
      const int vl = tid & 31;
      const uint4 v = *reinterpret_cast<const uint4*>(
          dl_g + vl * 128 + ((((tid >> 5) ^ vl) & 7) << 4));
      dbp += bf16_lo(v.x);
      dbp += bf16_hi(v.x);
      dbp += bf16_lo(v.y);
      dbp += bf16_hi(v.y);
      dbp += bf16_lo(v.z);
      dbp += bf16_hi(v.z);
      dbp += bf16_lo(v.w);
      dbp += bf16_hi(v.w);
    }
    wgmma_wait<0>();
    warpgroup_barrier(w);
    if (refill) dw2_load_chunk(ring, full_w, hmap, col0, kHalf - 1, rb + 1, k);
  }

#pragma unroll
  for (int jj = 0; jj < kHalf; ++jj) {
    {
      fence_operands(acc[jj]);
      const int h_a = (w * kHalf + jj) * kChunk + warp * 16 + g;
      const int h_b = h_a + 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + 8 * j + 2 * t4 + e;
          if (col < C) {
            dw2k[static_cast<size_t>(h_a) * C + col] = acc[jj][4 * j + e];
            dw2k[static_cast<size_t>(h_b) * C + col] = acc[jj][4 * j + 2 + e];
          }
        }
      }
    }
  }
  // a column's eight partial sums (rows 8q .. 8q + 7 of every block, q = 0..7),
  // added in that order
  float* dbuf = reinterpret_cast<float*>(gen + kDwOffDb);
  dbuf[tid] = dbp;
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  if (tid < kDwVt && v0 + tid < C) {
    float sum = dbuf[tid];
#pragma unroll
    for (int q = 1; q < 8; ++q) sum += dbuf[q * kDwVt + tid];
    db2k[v0 + tid] = sum;
  }
}

template <int kHalf>
__global__ void __launch_bounds__(kDwThreads, 1)
ce_dw2_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
              const uint16_t* __restrict__ b2, const int* __restrict__ targets,
              const float* __restrict__ logz, const float* __restrict__ gin,
              float* __restrict__ dw2, float* __restrict__ db2, int N, int C) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t w_bar = base + kDwOffBar;
  const uint32_t part_bar = w_bar + 8;
  const uint32_t dl_bar = w_bar + 16;
  const uint32_t full_bar = w_bar + 24;
  constexpr int Hh = 2 * kHalf * kChunk;

  const int k = blockIdx.y;
  const int v0 = blockIdx.x * kDwVt;
  if (threadIdx.x == 0) {
    mbar_init(w_bar, 1);
    mbar_init(part_bar, 8);  // one arrival a warp
    mbar_init(dl_bar, 8);
    for (int s = 0; s < 2 * kDwMaxHalf; ++s) mbar_init(full_bar + 8 * s, 1);  // the TMA request
    mbar_fence_init();
    tma_prefetch_map(&hmap);
    tma_prefetch_map(&wmap);
    // the block's tile of w2t, resident for the whole walk
    mbar_arrive_expect_tx(w_bar, 2 * kHalf * kDwWBoxBytes);
    for (int j = 0; j < 2 * kHalf; ++j) {
      tma_load_3d(base + kDwOffW + j * kDwWBoxBytes, &wmap, w_bar, j * kChunk, v0, k);
    }
  }
  __syncthreads();

  const size_t kn = static_cast<size_t>(k) * N;
  dw2_consume<kHalf>(base, gen, &hmap, w_bar, part_bar, dl_bar, full_bar,
                     b2 + static_cast<size_t>(k) * C, targets + kn, logz + kn, gin + kn,
                     dw2 + static_cast<size_t>(k) * Hh * C, db2 + static_cast<size_t>(k) * C,
                     warpgroup_index(), k, v0, N, C);
}

bool valid_shape(int K, int N, int Hh, int C) {
  return K > 0 && K <= 65535 && N > 0 && C > 0 && static_cast<long long>(K) * N <= INT_MAX &&
         Hh >= 128 && Hh <= kMaxHh && Hh % 128 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(); cudaErrorInvalidValue for shapes the kernels do not take.

// `w2t` is w2 transposed, bf16 [K, C, Hh]; `tlogit` fp32 [K, N] scratch that
// the pre-pass fills with the targets' logits.
extern "C" int ssr_fused_ce_fwd_bf16(const void* hidden, const void* w2t, const void* b2,
                                     const void* targets, void* tlogit, void* nll, void* logz,
                                     void* hits, int K, int N, int Hh, int C, int top,
                                     void* stream) {
  if (!valid_shape(K, N, Hh, C)) return static_cast<int>(cudaErrorInvalidValue);
  // first, because a runtime call binds the device's context to this thread,
  // which cuTensorMapEncodeTiled needs (autograd runs on its own threads)
  cudaError_t err = allow_smem(ce_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the maps hold the tensors' addresses: encoded for every launch
  CUtensorMap hmap, wmap;
  err = encode_rows_map(&hmap, hidden, K, N, Hh, kFwdRows);
  if (err == cudaSuccess) err = encode_rows_map(&wmap, w2t, K, C, Hh, kFwdVt);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = K * N;
  const int per_block = kTlThreads / 32;
  ce_target_logit_kernel<<<(rows + per_block - 1) / per_block, kTlThreads, 0, st>>>(
      static_cast<const uint16_t*>(hidden), static_cast<const uint16_t*>(w2t),
      static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
      static_cast<float*>(tlogit), rows, N, Hh, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kFwdRows - 1) / kFwdRows, K);
  ce_fwd_kernel<<<grid, kFwdThreads, kFwdSmem, st>>>(
      hmap, wmap, static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
      static_cast<const float*>(tlogit), static_cast<float*>(nll), static_cast<float*>(logz),
      static_cast<float*>(hits), N, Hh, C, top);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// One instance of the dhidden kernel for each (chunks a warpgroup, blocks a cluster).
template <int kQ, int kCS>
int launch_dhidden(const void* hidden, const void* w2t, const void* b2, const void* targets,
                   const void* logz, const void* g, void* dhidden, int K, int N, int Hh, int C,
                   void* stream) {
  // first, because a runtime call binds the device's context to this thread,
  // which cuTensorMapEncodeTiled needs (autograd runs on its own threads)
  cudaError_t err = allow_smem(ce_dhidden_kernel<kQ, kCS>, kDhSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap hmap, wmap;
  err = encode_rows_map(&hmap, hidden, K, N, Hh, kDhRows);
  if (err == cudaSuccess) err = encode_rows_map(&wmap, w2t, K, C, Hh, kDhVt);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCS * ((N + kDhRows - 1) / kDhRows), K);
  cfg.blockDim = dim3(kDhThreads);
  cfg.dynamicSmemBytes = kDhSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, ce_dhidden_kernel<kQ, kCS>, hmap, wmap,
                           static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
                           static_cast<const float*>(logz), static_cast<const float*>(g),
                           static_cast<uint16_t*>(dhidden), N, Hh, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `w2t` is w2 transposed, bf16 [K, C, Hh]. Hh of up to 512 is split over the
// two warpgroups of one block; above, over the four of a 2-block cluster
// (chunks of 64 columns, the last warpgroup's padded with zeros at 640 and 896).
extern "C" int ssr_fused_ce_bwd_dhidden_bf16(const void* hidden, const void* w2t,
                                             const void* b2, const void* targets,
                                             const void* logz, const void* g,
                                             void* dhidden, int K, int N, int Hh, int C,
                                             void* stream) {
  if (!valid_shape(K, N, Hh, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int nch = Hh / kChunk;
#define SSR_DH_CASE(Q, CS) \
  return launch_dhidden<Q, CS>(hidden, w2t, b2, targets, logz, g, dhidden, K, N, Hh, C, stream)
  if (nch <= 2 * kDhMaxQ) {
    switch (nch / 2) {
      case 1: SSR_DH_CASE(1, 1);
      case 2: SSR_DH_CASE(2, 1);
      case 3: SSR_DH_CASE(3, 1);
      case 4: SSR_DH_CASE(4, 1);
    }
  } else {
    switch ((nch + 3) / 4) {
      case 3: SSR_DH_CASE(3, 2);
      case 4: SSR_DH_CASE(4, 2);
    }
  }
#undef SSR_DH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// One instance of the dw2/db2 kernel for each Hh / 128.
template <int kHalf>
int launch_dw2(const void* hidden, const void* w2t, const void* b2, const void* targets,
               const void* logz, const void* g, void* dw2, void* db2, int K, int N, int C,
               void* stream) {
  // first, because a runtime call binds the device's context to this thread,
  // which cuTensorMapEncodeTiled needs (autograd runs on its own threads)
  cudaError_t err = allow_smem(ce_dw2_kernel<kHalf>, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int Hh = 2 * kHalf * kChunk;
  CUtensorMap hmap, wmap;
  err = encode_rows_map(&hmap, hidden, K, N, Hh, kDwRows);
  if (err == cudaSuccess) err = encode_rows_map(&wmap, w2t, K, C, Hh, kDwVt);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kDwVt - 1) / kDwVt, K);
  ce_dw2_kernel<kHalf><<<grid, kDwThreads, kDwSmem, static_cast<cudaStream_t>(stream)>>>(
      hmap, wmap, static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
      static_cast<const float*>(logz), static_cast<const float*>(g),
      static_cast<float*>(dw2), static_cast<float*>(db2), N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `w2t` is w2 transposed, bf16 [K, C, Hh].
extern "C" int ssr_fused_ce_bwd_dw2_bf16(const void* hidden, const void* w2t, const void* b2,
                                         const void* targets, const void* logz,
                                         const void* g, void* dw2, void* db2, int K, int N,
                                         int Hh, int C, void* stream) {
  if (!valid_shape(K, N, Hh, C)) return static_cast<int>(cudaErrorInvalidValue);
  switch (Hh / (2 * kChunk)) {
#define SSR_DW2_CASE(H) \
  case H:               \
    return launch_dw2<H>(hidden, w2t, b2, targets, logz, g, dw2, db2, K, N, C, stream)
    SSR_DW2_CASE(1);
    SSR_DW2_CASE(2);
    SSR_DW2_CASE(3);
    SSR_DW2_CASE(4);
    SSR_DW2_CASE(5);
    SSR_DW2_CASE(6);
    SSR_DW2_CASE(7);
    SSR_DW2_CASE(8);
#undef SSR_DW2_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
