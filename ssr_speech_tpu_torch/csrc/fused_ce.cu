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
// weights as w2 bf16 [K, Hh, C] (dhidden) or as their transpose w2t bf16
// [K, C, Hh] (forward, dw2/db2), which the wrapper makes once a step: its rows
// are 2 Hh bytes, a pitch the TMA unit takes at any C. Hh a multiple of 128 up
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
// dhidden (`ce_dhidden_kernel`) is the simple first version still: a block of 8
// warps owns 32 rows and keeps their hidden rows in shared memory; vocab tiles
// of 32 columns of w2 are staged beside them with plain loads, each warp
// computes a 16x8 piece of the 32x32 logits tile with mma.sync m16n8k16
// (mma_fragments.cuh), the tile's bf16 dlogits go through shared memory into a
// second product against the same w2 tile, dhidden accumulating in registers
// (each warp owns Hh/8 of the hidden columns). What it leaves on the table:
// wgmma, TMA double-buffering of the w2 tiles, larger row blocks.
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

// dhidden's tiles
constexpr int kRows = 32;      // rows per block
constexpr int kVt = 32;        // vocab columns per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWPitch = kVt + 8;
constexpr int kMaxHh = 1024;

__host__ __device__ constexpr int h_pitch(int hh) { return hh + 8; }

__host__ __device__ constexpr size_t tiles_smem(int hh) {
  // hidden rows, one w2 tile, the bf16 dlogits tile, row statistics
  return (static_cast<size_t>(kRows) * h_pitch(hh) + static_cast<size_t>(hh) * kWPitch +
          kRows * kWPitch) * sizeof(uint16_t) + 3 * kRows * sizeof(float);
}

// rows [r0, r0 + 32) of hidden[k] ([N, Hh]) into hs; zero past N
__device__ __forceinline__ void load_hidden(uint16_t* hs, const uint16_t* hid, int r0,
                                            int N, int Hh, int tid) {
  const int per_row = Hh / 8;
  for (int i = tid; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) val = *reinterpret_cast<const uint4*>(hid + static_cast<size_t>(r0 + r) * Hh + c);
    *reinterpret_cast<uint4*>(hs + r * h_pitch(Hh) + c) = val;
  }
}

// columns [v0, v0 + 32) of w2[k] ([Hh, C]) into ws; zero past C
__device__ __forceinline__ void load_w2_tile(uint16_t* ws, const uint16_t* w2, int v0,
                                             int C, int Hh, int tid) {
  if (C % 8 == 0 && v0 + kVt <= C) {  // 16-byte aligned rows, whole tile
    for (int i = tid; i < Hh * (kVt / 8); i += kThreads) {
      const int h = i / (kVt / 8);
      const int c = (i % (kVt / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + h * kWPitch + c) =
          *reinterpret_cast<const uint4*>(w2 + static_cast<size_t>(h) * C + v0 + c);
    }
  } else {
    for (int i = tid; i < Hh * kVt; i += kThreads) {
      const int h = i / kVt;
      const int c = i % kVt;
      ws[h * kWPitch + c] = (v0 + c < C) ? w2[static_cast<size_t>(h) * C + v0 + c] : 0;
    }
  }
}

// This warp's 16x8 piece of the 32x32 logits tile hs . ws (no bias): rows
// (warp & 1) * 16, columns (warp >> 1) * 8.
__device__ __forceinline__ void logits_piece(float* c, const uint16_t* hs,
                                             const uint16_t* ws, int Hh, int warp,
                                             int g, int t4) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const int m0 = (warp & 1) * 16;
  const int n0 = (warp >> 1) * 8;
  for (int k0 = 0; k0 < Hh; k0 += 16) {
    uint32_t a[4], b[2];
    load_a(a, hs, h_pitch(Hh), m0, k0, g, t4);
    load_b_kn(b, ws, kWPitch, k0, n0, g, t4);
    mma_16816(c, a, b[0], b[1]);
  }
}

// rows' targets, logz and cotangents into shared memory (zero g past N)
__device__ __forceinline__ void load_row_stats(int* ts, float* zs, float* gs,
                                               const int* tgt, const float* logz,
                                               const float* gin, int r0, int N, int tid) {
  if (tid < kRows) {
    const bool in = r0 + tid < N;
    ts[tid] = in ? tgt[r0 + tid] : -1;
    zs[tid] = in ? logz[r0 + tid] : 0.f;
    gs[tid] = in ? gin[r0 + tid] : 0.f;
  }
}

// The 32x32 bf16 dlogits tile of vocab columns [v0, v0 + 32) into ds.
__device__ __forceinline__ void dlogits_tile(uint16_t* ds, const uint16_t* hs,
                                             const uint16_t* ws, const uint16_t* b2,
                                             const int* ts, const float* zs,
                                             const float* gs, int v0, int C, int Hh,
                                             int warp, int g, int t4) {
  float c[4];
  logits_piece(c, hs, ws, Hh, warp, g, t4);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = (warp & 1) * 16 + g + (e >= 2 ? 8 : 0);
    const int cl = (warp >> 1) * 8 + t4 * 2 + (e & 1);
    const int col = v0 + cl;
    float d = 0.f;
    if (col < C) {
      const float x = c[e] + bf16_float(b2[col]);
      d = (expf(x - zs[r]) - (col == ts[r] ? 1.f : 0.f)) * gs[r];
    }
    ds[r * kWPitch + cl] = bf16_bits(d);
  }
}

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

__global__ void __launch_bounds__(kThreads)
ce_dhidden_kernel(const uint16_t* __restrict__ hidden, const uint16_t* __restrict__ w2,
                  const uint16_t* __restrict__ b2, const int* __restrict__ targets,
                  const float* __restrict__ logz, const float* __restrict__ gin,
                  uint16_t* __restrict__ dhidden, int N, int Hh, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ws = hs + kRows * h_pitch(Hh);
  uint16_t* ds = ws + Hh * kWPitch;
  int* ts = reinterpret_cast<int*>(ds + kRows * kWPitch);
  float* zs = reinterpret_cast<float*>(ts + kRows);
  float* gs = zs + kRows;

  const int k = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t kn = static_cast<size_t>(k) * N;
  const uint16_t* w2k = w2 + static_cast<size_t>(k) * Hh * C;

  load_hidden(hs, hidden + kn * Hh, r0, N, Hh, tid);
  load_row_stats(ts, zs, gs, targets + kn, logz + kn, gin + kn, r0, N, tid);

  const int cols = Hh / 8;  // this warp's hidden columns [h0, h0 + cols)
  const int h0 = warp * cols;
  const int ntiles = cols / 8;  // <= 16
  float acc[2][16][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int v0 = 0; v0 < C; v0 += kVt) {
    __syncthreads();
    load_w2_tile(ws, w2k, v0, C, Hh, tid);
    __syncthreads();
    dlogits_tile(ds, hs, ws, b2 + static_cast<size_t>(k) * C, ts, zs, gs, v0, C, Hh, warp, g, t4);
    __syncthreads();
    // dhidden[32, h] += dlogits[32, 32] . w2_tile^T[32, h]
#pragma unroll
    for (int kk = 0; kk < kVt / 16; ++kk) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        load_a(a, ds, kWPitch, mt * 16, kk * 16, g, t4);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          if (nt < ntiles) {
            uint32_t b[2];
            load_b_nk(b, ws, kWPitch, kk * 16, h0 + nt * 8, g, t4);
            mma_16816(acc[mt][nt], a, b[0], b[1]);
          }
        }
      }
    }
  }

  uint16_t* out = dhidden + kn * Hh;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = r0 + mt * 16 + g;
    const int rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt < ntiles) {
        const int c = h0 + nt * 8 + t4 * 2;
        if (ra < N) {
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra) * Hh + c) =
              pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
        }
        if (rb < N) {
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(rb) * Hh + c) =
              pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
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

extern "C" int ssr_fused_ce_bwd_dhidden_bf16(const void* hidden, const void* w2,
                                             const void* b2, const void* targets,
                                             const void* logz, const void* g,
                                             void* dhidden, int K, int N, int Hh, int C,
                                             void* stream) {
  if (!valid_shape(K, N, Hh, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ce_dhidden_kernel, tiles_smem(kMaxHh));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, K);
  ce_dhidden_kernel<<<grid, kThreads, tiles_smem(Hh), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(hidden), static_cast<const uint16_t*>(w2),
      static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
      static_cast<const float*>(logz), static_cast<const float*>(g),
      static_cast<uint16_t*>(dhidden), N, Hh, C);
  return static_cast<int>(cudaGetLastError());
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
