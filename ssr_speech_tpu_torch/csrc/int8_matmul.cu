// Int8 weight-streaming matvecs for Hopper (sm_90a): a few activation rows
// against an int8 weight matrix with one fp32 scale per output column.
//
// Replaces the three Pallas TPU kernels of the int8 decode probes:
//
//   ssr_int8_matvec_f32    <- tools/int8_matmul.py `_kernel` (int8_matmul):
//       y[b,n] = (sum_k x[b,k] * float(w[k,n])) * scale[n], an fp32 dot;
//   ssr_int8_matvec_bf16   <- tools/int8_kernel_probe2.py `kern`, mode "bf16":
//       the weight converted to bf16 (exact for int8), bf16 x bf16 products
//       with fp32 accumulation, times scale;
//   ssr_int8_matvec_int8   <- the same `kern`, mode "int8": the activation
//       quantised in the kernel, xq = clip(rint(32 x), +-127), int8 x int8
//       products accumulated exactly in int32, times (1/32) * scale;
//   ssr_int8_mega_bf16     <- tools/int8_kernel_probe3.py `kern` (mega): L
//       chained layers in ONE launch; h stays fp32 between layers, is
//       rounded to bf16 for each product, and the first K columns of each
//       layer's output feed the next layer.
//
// x is bf16 [B, K] (row pitch ldx elements), w int8 [K, N] with N contiguous,
// scale fp32 [N], out bf16 [B, N]. The first three take any B >= 1; the
// megakernel at most 8.
//
// The first two compute the same function: every bf16 x is exact in fp32 and
// so is every int8 weight, so each product x * w is exact in fp32 and the two
// differ only in the order of the fp32 sum. Both run one body on the tensor
// cores (`stream_kernel<false, G>`), and K8's int8 mode the same walk with
// int8 products (`stream_kernel<true, G>`).
//
// What bounds them: bytes. Up to about 64 rows a layer does 2*B*K*N
// operations on K*N weight bytes, below the card's operations-per-byte ridge,
// so the least time is the weight's bytes over the memory rate. The design
// keeps the weight streaming and takes the rest off its path:
//
// - A cluster of two blocks owns a 128-column strip of the output; the two
//   split K by stages (block `rank` takes stages rank, rank + 2, ...). One
//   thread of a block streams its stages by TMA, boxes of 256 k-rows x 128
//   bytes (32 KB) with the 128-byte swizzle, into a ring of 3 stages behind
//   mbarriers. (A first version with 64-column blocks and 64-byte boxes was
//   slower than the kernel it replaced: a TMA box costs about the same per
//   row whether its rows are 64 or 128 bytes wide, PERF.md.)
// - 16 warps a block for one group of rows, 8 for more (their accumulators
//   need the registers; two blocks an SM either way): column half w & 1 (64
//   columns), k-part w >> 1 of P = 8 or 4, which takes k-steps part,
//   part + P, ... of every stage (16 rows in mode bf16, 32 in int8). The warps read their fragments from shared memory and run
//   mma.sync with the WEIGHT as the A operand (16 output columns x k) and the
//   activations as B (k x 8 batch rows). Per k-step a lane loads 8 bytes
//   (columns 8g .. 8g+7 of its half, g = lane / 4) from rows 2q + {0, 1, 8,
//   9} (+ 16 in mode int8), q = lane % 4: for bf16 those are the rows the
//   instruction gives a lane; for int8 the instruction's k index is permuted
//   to them, on both operands. With the swizzle (chunk ^ row % 8) the four
//   rows a quarter-warp reads meet no bank conflict. The bytes are gathered
//   in registers (`prmt`): for bf16 two bytes become a bf16x2 in four
//   instructions (`pair_bf16`, exact); for int8 a 4x4 byte transpose builds
//   the k-quads. The activations come from global
//   memory (L2); up to 16 rows the next stage's are loaded while this one
//   computes.
// - Rows: a block carries G groups of 8 batch rows (G = 1, 2, 4 or 8, a
//   template parameter); each dequantised weight fragment feeds the G
//   products. More than 64 rows take more clusters in y, each streaming the
//   strip again (from L2 when the matrix fits there).
// - Programmatic dependent launch: the thread that initialises the barriers
//   issues the first stages, and only then does the block wait
//   (griddepcontrol.wait) for the grid before it in the stream, whose output
//   may be x. Once its last stage is issued a block lets the next grid be
//   scheduled (griddepcontrol.launch_dependents). In a chain, layer l+1's
//   blocks (two fit an SM beside layer l's) stream their first 96 KB of
//   weights while layer l drains. Nothing is written before the wait, and
//   nothing may write the weights early (only these kernels trigger early,
//   and they write only `out`).
// - Partial sums in one fixed order, no atomics, so two runs repeat bit for
//   bit (the int8 mode's int32 sums are exact in any order): in a block the
//   k-parts meet in a tree through shared memory (the ring, free by then),
//   part i += part i + h for h = P / 2 .. 1; rank 1 then pushes its two warps' sums with
//   st.async into a buffer of rank 0's (counted on rank 0's barrier), and
//   rank 0 adds them after its own, scales, and stores 16 bytes (8 columns)
//   a row.
// - The megakernel (first form, PR 3) is a persistent cooperative grid of 16
//   warps a block (one block per 64-column tile, at most what is
//   co-resident): layers are separated by grid.sync(), h is double-buffered
//   in global memory as fp32 [2, 8, K] (32 KB a buffer: it lives in L2) and
//   read back with ld.global.cg, which bypasses the non-coherent L1. Every
//   column of every layer is computed and every byte of w is read, as on the
//   TPU; only the first K columns are fed back. Its 16 warps' partials meet
//   in shared memory and are added in warp order.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tma_wgmma.cuh"
#include "mma_fragments.cuh"

// Timer hooks: tools/torch_int8_cycles.py defines them in a copy of this file.
#ifndef SSR_INT8_TIMES
#define SSR_BEGIN()
#define SSR_MARK(slot)
#define SSR_WAIT_START()
#define SSR_WAIT_STOP()
#define SSR_END()
#endif

namespace cg = cooperative_groups;

namespace {

using ssr::bf16_bits;
using ssr::bf16_float;
using ssr::mma_16816;
using ssr::pack_bf16;
using namespace ssr::sm90;

constexpr int kTileN = 64;    // output columns per block
constexpr int kWarps = 16;    // the megakernel: K is split over the warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;      // batch rows the megakernel carries
constexpr int kRed = kWarps * kRows * kTileN;  // its partial sums, 4 bytes each

constexpr int kStripN = 128;                       // output columns of a cluster's strip
constexpr int kCluster = 2;                        // blocks of a cluster: they split K
constexpr int kStageRows = 256;                    // k-rows of one TMA box
constexpr int kStageBytes = kStageRows * kStripN;  // 32 KB of int8
constexpr int kStages = 3;                         // the ring
constexpr int kWideParts = 8;  // warps along K in a block of one row group
// warps along K in a block of G row groups (x 2 column halves of 64): one
// group leaves registers for 16 warps a block at two blocks an SM
__host__ __device__ constexpr int k_parts(int G) { return G == 1 ? kWideParts : 4; }
__host__ __device__ constexpr int s_threads(int G) { return 2 * k_parts(G) * 32; }
constexpr int kMaxGroups = 8;                      // 8-row groups a block carries
// shared memory of a block carrying G row groups: the ring, the barriers,
// the buffer for rank 1's partials (its own, so that rank 1 sends them
// without waiting for rank 0 to finish with its ring), and the slack to
// align the ring to 1024 bytes
constexpr size_t stream_smem(int G) {
  return kStages * kStageBytes + 8 * (2 * kStages + 2) + G * 4096 + 1024;
}

// int8 byte j of a word whose bytes were flipped to offset binary
// (word ^ 0x80808080), as a float: 0x4B0000uu is 2^23 + uu, and uu = v + 128.
__device__ __forceinline__ float byte_to_float(uint32_t flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + j)) -
         8388736.0f;
}

// Two floats that are exact in bf16 -> packed bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t pack_exact_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte j of `lo` and byte j of `hi` (int8) as a bf16x2, lo in the low half,
// exactly: with m the low 7 bits and s the sign bit of a byte, v = (128 + m)
// - 128 (1 + s), and 0x4300 | m, 0x4300 | s << 7 are those two terms as exact
// bf16, whose difference (an integer in [-128, 127]) is exact too. Four
// instructions a pair.
__device__ __forceinline__ uint32_t pair_bf16(uint32_t lo, uint32_t hi, int j) {
  const uint32_t p = __byte_perm(lo, hi, 0x4400u + 0x1111u * j);  // bytes 0, 2: lo[j], hi[j]
  const uint32_t a = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// 4x4 byte transpose: out[j] holds byte j of r0, r1, r2, r3 (low to high).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, uint32_t* out) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0[0] r1[0] r0[1] r1[1]
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0[2] r1[2] r0[3] r1[3]
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// D = A.B + D for one 16x8x32 tile of int8 (int32 accumulate). Not volatile:
// the compiler may interleave it with the loads and conversions of the next
// k-step.
__device__ __forceinline__ void mma_16832_s8(int* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(32 x), +-127) as an int8 byte (rint rounds half to even).
__device__ __forceinline__ uint32_t quant_byte(uint32_t bf16) {
  const float t = fminf(fmaxf(rintf(bf16_float(bf16 & 0xFFFFu) * 32.0f), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(t)) & 0xFFu;
}

// D = A.B + D for one 16x8x16 bf16 tile (fp32 accumulate), as ssr::mma_16816
// but not volatile, as mma_16832_s8.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------- weight streaming
//
// kInt8: int8 x int8 products (the activations quantised here), else bf16 x
// bf16; G groups of 8 batch rows from row blockIdx.y * 8G. A cluster of two
// blocks owns a 128-column strip; block `rank` streams its stages t = 2u +
// rank. Warp w takes the column half w & 1 and the k-part w >> 1: k-steps
// part, part + kKParts, ... of every stage. acc[grp][j] is the C fragment of mma j
// of group grp: its 16 A rows are the columns 8g + j (rows 0-7) and
// 8g + j + 4 (rows 8-15) of the warp's 64 columns, so
//   acc[grp][j][0], [1] = y[8grp + 2q], y[8grp + 2q + 1] at column 8g + j
//   acc[grp][j][2], [3] = the same rows at column 8g + j + 4.
template <bool kInt8, int G>
__global__ void __launch_bounds__(s_threads(G), G <= 4 ? 2 : 1)
stream_kernel(const __grid_constant__ CUtensorMap wmap, const uint16_t* x, int ldx,
              const float* __restrict__ scale, uint16_t* out, int B, int K, int N) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kStep = kInt8 ? 32 : 16;         // k-rows of one mma
  constexpr int kPerStage = kStageRows / kStep;  // k-steps of a stage
  constexpr int kKParts = k_parts(G);
  constexpr int kMine = kPerStage / kKParts;     // ... a warp takes
  constexpr int kLoads = kStep / 4;              // 8-byte weight loads a k-step
  constexpr int kVals = G * 16;                  // accumulators a thread
  constexpr uint32_t kSendBytes = 2 * kVals * 32 * 4;  // warps 0 and 1's partials
  static_assert(kPerStage % kKParts == 0, "the k-parts share every stage");
  static_assert(kKParts * kVals * 32 * 4 <= kStages * kStageBytes, "the tree fits the ring");
  extern __shared__ uint8_t smem_raw[];
  SSR_BEGIN();
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t bars = ring + kStages * kStageBytes;  // full[kStages], empty[kStages]
  const uint32_t recv_bar = bars + 16 * kStages;  // rank 1's partials are in
  const uint32_t recv = recv_bar + 16;             // ... this buffer (16-byte aligned)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int half = warp & 1, part = warp >> 1;
  const uint32_t rank = cluster_rank();
  const int n0 = (blockIdx.x / kCluster) * kStripN;
  const int r0 = blockIdx.y * 8 * G;
  const int T = (K + kStageRows - 1) / kStageRows;                      // stages of the strip
  const int Tr = (T - static_cast<int>(rank) + kCluster - 1) / kCluster;  // ... of this block
  // the first k-row of this block's stage u: stages alternate between the two
  auto stage_k = [&](int u) { return (kCluster * u + static_cast<int>(rank)) * kStageRows; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 2 * kKParts);
    }
    mbar_init(recv_bar, 1);
    mbar_fence_init();
    if (rank == 0) mbar_arrive_expect_tx(recv_bar, kSendBytes);
    for (int u = 0; u < Tr && u < kStages; ++u) {  // the weights need nothing computed
      mbar_arrive_expect_tx(bars + 8 * u, kStageBytes);
      tma_load_2d(ring + u * kStageBytes, &wmap, bars + 8 * u, n0,
                  stage_k(u));
    }
  }
  __syncthreads();
  cluster_sync();  // the barriers of both blocks are ready
  if (Tr <= kStages) pdl_launch_dependents();  // every thread: its last stage is issued
  pdl_wait();  // x may be the previous grid's output
  SSR_MARK(2);

  // this lane's byte offsets in a k-step of a stage: rows 2q + {0, 1, 8, 9}
  // (+ 16 for the int8 mode's second half), columns 64 half + 8g .. 8g + 7,
  // the 16-byte chunk xor-ed with the row's index mod 8 (the swizzle)
  uint32_t roff[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int row = 2 * q + (i & 1) + 8 * (i >> 1);
    roff[i] = row * kStripN + ((((half * 4 + (g >> 1)) ^ row) & 7) << 4) + (g & 1) * 8;
  }
  // the activations: row r0 + 8grp + g, elements k0 + 2q + {0, 1} (+ 8, 16, 24)
  const uint16_t* xrow[G];
  bool xok[G];
#pragma unroll
  for (int grp = 0; grp < G; ++grp) {
    const int r = r0 + 8 * grp + g;
    xok[grp] = r < B;
    xrow[grp] = x + static_cast<size_t>(xok[grp] ? r : 0) * ldx + 2 * q;
  }

  Acc acc[G][4][4];
#pragma unroll
  for (int grp = 0; grp < G; ++grp)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[grp][j][0] = acc[grp][j][1] = acc[grp][j][2] = acc[grp][j][3] = 0;

  // the activation words (2 bf16 each) of k-step m of a stage for group grp:
  // read from a row and k that exist, zero where the row or k does not
  constexpr int kWords = kStep / 8;  // 2 (bf16) or 4 (int8)
  auto load_x = [&](int kbase, int m, int grp, uint32_t* words) {
    const int k0 = kbase + (part + m * kKParts) * kStep;
    const bool ok = xok[grp] && k0 < K;
    const uint16_t* p = xrow[grp] + (k0 < K ? k0 : 0);
#pragma unroll
    for (int v = 0; v < kWords; ++v) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(p + 8 * v);
      words[v] = ok ? word : 0u;
    }
  };
  // up to 16 rows, the next stage's activations are loaded while this one
  // computes (their latency is hidden, not paid once a k-step)
  constexpr bool kPreload = G <= 2;
  constexpr int kPm = kPreload ? kMine : 1, kPg = kPreload ? G : 1;
  uint32_t xs[kPm][kPg][kWords], xn[kPm][kPg][kWords];
  auto load_stage = [&](int u, uint32_t (*dst)[kPg][kWords]) {
#pragma unroll
    for (int m = 0; m < kPm; ++m)
#pragma unroll
      for (int grp = 0; grp < kPg; ++grp)
        load_x(stage_k(u), m, grp, dst[m][grp]);
  };
  if constexpr (kPreload) load_stage(0, xs);

  for (int u = 0; u < Tr; ++u) {
    const int slot = u % kStages;
    const int kbase = stage_k(u);
    if constexpr (kPreload) load_stage(u + 1 < Tr ? u + 1 : u, xn);
    if (u > 0) SSR_WAIT_START();
    mbar_wait(bars + 8 * slot, (u / kStages) & 1);
    if (u > 0) SSR_WAIT_STOP();
    __syncwarp();  // thread 0 may come from the refill below
    if (u == 0) SSR_MARK(1);
    const uint8_t* stage = ring_ptr + slot * kStageBytes;
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int step = part + m * kKParts;
      const int k0 = kbase + step * kStep;
      if (k0 < K) {  // warp-uniform; K is a multiple of kStep
        const uint8_t* sp = stage + step * kStep * kStripN;
        uint2 r[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) r[i] = *reinterpret_cast<const uint2*>(sp + roff[i]);
        uint32_t b0[G], b1[G];
#pragma unroll
        for (int grp = 0; grp < G; ++grp) {
          uint32_t words[kWords];
          if constexpr (kPreload) {
#pragma unroll
            for (int v = 0; v < kWords; ++v) words[v] = xs[m][grp][v];
          } else {
            load_x(kbase, m, grp, words);
          }
          if constexpr (kInt8) {
            uint32_t e[8];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              e[2 * v] = quant_byte(words[v]);
              e[2 * v + 1] = quant_byte(words[v] >> 16);
            }
            b0[grp] = e[0] | e[1] << 8 | e[2] << 16 | e[3] << 24;
            b1[grp] = e[4] | e[5] << 8 | e[6] << 16 | e[7] << 24;
          } else {
            b0[grp] = words[0];
            b1[grp] = words[1];
          }
        }
        if constexpr (kInt8) {
          uint32_t lo03[4], hi03[4], lo47[4], hi47[4];
          transpose4(r[0].x, r[1].x, r[2].x, r[3].x, lo03);
          transpose4(r[0].y, r[1].y, r[2].y, r[3].y, hi03);
          transpose4(r[4].x, r[5].x, r[6].x, r[7].x, lo47);
          transpose4(r[4].y, r[5].y, r[6].y, r[7].y, hi47);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a[4] = {lo03[j], hi03[j], lo47[j], hi47[j]};
#pragma unroll
            for (int grp = 0; grp < G; ++grp) mma_16832_s8(acc[grp][j], a, b0[grp], b1[grp]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t a[4];
            a[0] = pair_bf16(r[0].x, r[1].x, j);
            a[1] = pair_bf16(r[0].y, r[1].y, j);
            a[2] = pair_bf16(r[2].x, r[3].x, j);
            a[3] = pair_bf16(r[2].y, r[3].y, j);
#pragma unroll
            for (int grp = 0; grp < G; ++grp) mma_bf16(acc[grp][j], a, b0[grp], b1[grp]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + slot));  // this warp is done with it
    // refill the slot of the stage before (its consumers are most likely done)
    if (threadIdx.x == 0 && u >= 1 && u - 1 + kStages < Tr) {
      const int ps = (u - 1) % kStages;
      mbar_wait(bars + 8 * (kStages + ps), ((u - 1) / kStages) & 1);
      mbar_arrive_expect_tx(bars + 8 * ps, kStageBytes);
      tma_load_2d(ring + ps * kStageBytes, &wmap, bars + 8 * ps, n0, stage_k(u - 1 + kStages));
    }
    if (u >= 1 && u - 1 + kStages == Tr - 1) pdl_launch_dependents();  // the last stage is issued
    if constexpr (kPreload) {
#pragma unroll
      for (int m = 0; m < kPm; ++m)
#pragma unroll
        for (int grp = 0; grp < kPg; ++grp)
#pragma unroll
          for (int v = 0; v < kWords; ++v) xs[m][grp][v] = xn[m][grp][v];
    }
  }
  SSR_MARK(3);

  // the k-parts' partials: 8 -> 4 -> 2 -> 1 (or 4 -> 2 -> 1) through the
  // ring (free now), per column half, in one fixed order: part i += part
  // i + h for h = kKParts / 2 down to 1
  Acc* red = reinterpret_cast<Acc*>(smem_raw + (ring - smem_u32(smem_raw)));
  __syncthreads();
#pragma unroll
  for (int h2 = kKParts / 2; h2 >= 1; h2 /= 2) {
    if (part >= h2 && part < 2 * h2) {
#pragma unroll
      for (int grp = 0; grp < G; ++grp)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(((part - h2) * 2 + half) * kVals + grp * 16 + j * 4 + c) * 32 + lane] =
                acc[grp][j][c];
    }
    __syncthreads();
    if (part < h2) {
#pragma unroll
      for (int grp = 0; grp < G; ++grp)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[grp][j][c] += red[((part * 2 + half) * kVals + grp * 16 + j * 4 + c) * 32 + lane];
    }
    __syncthreads();
  }
  SSR_MARK(5);
  // then the cluster's: rank 1's two warps push theirs into rank 0's receive
  // buffer (16 bytes a store, counted on rank 0's recv barrier), rank 0 adds
  // them after its own, scales and stores
  if (rank == 1) {
    if (warp < 2) {
      const uint32_t dst = mapa_shared(recv, 0), bar = mapa_shared(recv_bar, 0);
#pragma unroll
      for (int v = 0; v < kVals; v += 4) {
        const int grp = v >> 4, j = (v >> 2) & 3;
        st_async_f32x4(dst + ((warp * (kVals / 4) + v / 4) * 32 + lane) * 16,
                       *reinterpret_cast<const float*>(&acc[grp][j][0]),
                       *reinterpret_cast<const float*>(&acc[grp][j][1]),
                       *reinterpret_cast<const float*>(&acc[grp][j][2]),
                       *reinterpret_cast<const float*>(&acc[grp][j][3]), bar);
      }
    }
  } else {
    if (warp < 2) {
      mbar_wait(recv_bar, 0);
      const Acc* got = reinterpret_cast<const Acc*>(smem_raw + (recv - smem_u32(smem_raw)));
#pragma unroll
      for (int v = 0; v < kVals; v += 4) {
        const int grp = v >> 4, j = (v >> 2) & 3;
        const Acc* in = got + ((warp * (kVals / 4) + v / 4) * 32 + lane) * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[grp][j][c] += in[c];
      }
      const int c0 = n0 + 64 * warp + 8 * g;  // this lane's 8 columns
      if (c0 < N) {
        const float4 sa = *reinterpret_cast<const float4*>(scale + c0);
        const float4 sb = *reinterpret_cast<const float4*>(scale + c0 + 4);
        const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
        for (int grp = 0; grp < G; ++grp)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * grp + 2 * q + h;
            if (row < B) {
              uint32_t packed[4];
#pragma unroll
              for (int pp = 0; pp < 4; ++pp) {
                float y[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = 2 * pp + e;  // column c0 + c
                  const Acc v = c < 4 ? acc[grp][c][h] : acc[grp][c - 4][2 + h];
                  y[e] = kInt8 ? (static_cast<float>(v) * (1.0f / 32.0f)) * sc[c]
                               : static_cast<float>(v) * sc[c];
                }
                packed[pp] = static_cast<uint32_t>(bf16_bits(y[0])) |
                             static_cast<uint32_t>(bf16_bits(y[1])) << 16;
              }
              *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + c0) =
                  make_uint4(packed[0], packed[1], packed[2], packed[3]);
            }
          }
      }
    }
  }
  SSR_END();
}

// ------------------------------------------------------------- megakernel
//
// One warp's share of a 64-column tile: rows k0 + 4q + {0..3} of every 16-row
// step it owns. acc[j] is the C fragment of mma j, whose 16 A rows are the
// columns n0 + 8g + j (rows 0-7) and n0 + 8g + j + 4 (rows 8-15):
//   acc[j][0], [1] = y[2q], y[2q+1] at column 8g + j
//   acc[j][2], [3] = y[2q], y[2q+1] at column 8g + j + 4
// The activations are fp32 rows written by other blocks (read through L2 and
// rounded to bf16 here).
__device__ __forceinline__ void warp_tile_bf16(const int8_t* __restrict__ w,
                                               const float* x, int ldx, int B,
                                               int K, int N, int n0, int warp,
                                               int lane, float (*acc)[4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int8_t* wp = w + n0 + g * 8;
#pragma unroll 2
  for (int k0 = warp * 16; k0 < K; k0 += kWarps * 16) {
    const int k = k0 + 4 * q;
    uint2 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(k + i) * N));
    uint32_t b0 = 0, b1 = 0;
    if (g < B) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          x + static_cast<size_t>(g) * ldx + k));
      b0 = pack_bf16(v.x, v.y);
      b1 = pack_bf16(v.z, v.w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i].x ^= 0x80808080u;
      r[i].y ^= 0x80808080u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      a[0] = pack_exact_bf16(byte_to_float(r[0].x, j), byte_to_float(r[1].x, j));
      a[1] = pack_exact_bf16(byte_to_float(r[0].y, j), byte_to_float(r[1].y, j));
      a[2] = pack_exact_bf16(byte_to_float(r[2].x, j), byte_to_float(r[3].x, j));
      a[3] = pack_exact_bf16(byte_to_float(r[2].y, j), byte_to_float(r[3].y, j));
      mma_16816(acc[j], a, b0, b1);
    }
  }
}

// The C fragments of a warp -> red[warp][row][column] (4-byte cells).
template <typename T>
__device__ __forceinline__ void store_partials(T* red, int warp, int lane,
                                               T (*acc)[4]) {
  const int g = lane >> 2, q = lane & 3;
  T* p = red + warp * kRows * kTileN;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[(2 * q) * kTileN + 8 * g + j] = acc[j][0];
    p[(2 * q + 1) * kTileN + 8 * g + j] = acc[j][1];
    p[(2 * q) * kTileN + 8 * g + j + 4] = acc[j][2];
    p[(2 * q + 1) * kTileN + 8 * g + j + 4] = acc[j][3];
  }
}

// h: fp32 [2][kRows][K] scratch. Layer l reads buffer l % 2 and writes the
// first K columns of its output into the other; the last layer also writes
// `out` (bf16 [B, K]).
__global__ void __launch_bounds__(kThreads)
mega_bf16_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* h,
                 uint16_t* __restrict__ out, int B, int L, int K, int N) {
  __shared__ float red[kRed];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = N / kTileN;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < kRows * K;
       i += gridDim.x * kThreads) {
    const int r = i / K, k = i % K;
    h[i] = r < B ? bf16_float(x[static_cast<size_t>(r) * K + k]) : 0.f;
  }
  grid.sync();
  for (int l = 0; l < L; ++l) {
    const float* src = h + (l & 1) * kRows * K;
    float* dst = h + ((l + 1) & 1) * kRows * K;
    const int8_t* wl = w + static_cast<size_t>(l) * K * N;
    const float* sl = scale + static_cast<size_t>(l) * N;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = t * kTileN;
      float acc[4][4];
      warp_tile_bf16(wl, src, K, B, K, N, n0, warp, lane, acc);
      store_partials<float>(red, warp, lane, acc);
      __syncthreads();
      for (int o = threadIdx.x; o < kRows * kTileN; o += kThreads) {
        const int b = o / kTileN, c = o % kTileN;
        float sum = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi)
          sum += red[(wi * kRows + b) * kTileN + c];
        const float y = sum * sl[n0 + c];
        if (n0 + c < K) {  // the columns the next layer reads
          dst[b * K + n0 + c] = y;
          if (l == L - 1 && b < B)
            out[static_cast<size_t>(b) * K + n0 + c] = bf16_bits(y);
        }
      }
      __syncthreads();  // red is reused by the next tile
    }
    grid.sync();
  }
}

int check_shapes(int B, int K, int N, int kstep, int max_rows) {
  if (B < 1 || B > max_rows || K < kstep || K % kstep || N < kTileN || N % kTileN)
    return cudaErrorInvalidValue;
  return 0;
}

int g_pdl = 1;  // launch the streaming kernels with programmatic dependent launch

template <bool kInt8, int G>
int launch_stream(const void* x, int ldx, const void* w, const void* scale, void* out, int B,
                  int K, int N, cudaStream_t stream) {
  auto kernel = stream_kernel<kInt8, G>;
  // also the runtime call that makes the context current before the encode
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(stream_smem(G)));
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = encode_int8_map(&map, w, K, N, kStageRows, kStripN, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = g_pdl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * ((N + kStripN - 1) / kStripN), (B + 8 * G - 1) / (8 * G));
  cfg.blockDim = dim3(s_threads(G));
  cfg.dynamicSmemBytes = stream_smem(G);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const uint16_t*>(x), ldx,
                         static_cast<const float*>(scale), static_cast<uint16_t*>(out), B, K, N);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// groups of 8 rows a block carries for B rows
int stream_groups(int B) { return B <= 8 ? 1 : B <= 16 ? 2 : B <= 32 ? 4 : kMaxGroups; }

template <bool kInt8>
int launch_rows(const void* x, int ldx, const void* w, const void* scale, void* out, int B,
                int K, int N, void* stream) {
  if (int e = check_shapes(B, K, N, kInt8 ? 32 : 16, 1 << 24)) return e;
  auto s = static_cast<cudaStream_t>(stream);
  switch (stream_groups(B)) {
    case 1: return launch_stream<kInt8, 1>(x, ldx, w, scale, out, B, K, N, s);
    case 2: return launch_stream<kInt8, 2>(x, ldx, w, scale, out, B, K, N, s);
    case 4: return launch_stream<kInt8, 4>(x, ldx, w, scale, out, B, K, N, s);
    default: return launch_stream<kInt8, kMaxGroups>(x, ldx, w, scale, out, B, K, N, s);
  }
}

template <bool kInt8, int G>
int occupancy(int* blocks) {
  auto kernel = stream_kernel<kInt8, G>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(stream_smem(G)));
  return e != cudaSuccess ? e
                          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, s_threads(G),
                                                                          stream_smem(G));
}

}  // namespace

// Every entry point returns 0 or the CUDA error of its launch; nothing here
// synchronises or allocates.

// K7: the TPU kernel's fp32 dot. Its products are exact in fp32, so it runs
// the bf16 body: the same function up to the order of the fp32 sum.
extern "C" int ssr_int8_matvec_f32(const void* x, int ldx, const void* w,
                                   const void* scale, void* out, int B, int K,
                                   int N, void* stream) {
  return launch_rows<false>(x, ldx, w, scale, out, B, K, N, stream);
}

extern "C" int ssr_int8_matvec_bf16(const void* x, int ldx, const void* w,
                                    const void* scale, void* out, int B, int K,
                                    int N, void* stream) {
  return launch_rows<false>(x, ldx, w, scale, out, B, K, N, stream);
}

extern "C" int ssr_int8_matvec_int8(const void* x, int ldx, const void* w,
                                    const void* scale, void* out, int B, int K,
                                    int N, void* stream) {
  return launch_rows<true>(x, ldx, w, scale, out, B, K, N, stream);
}

// Programmatic dependent launch on (1, the default) or off for the launches
// that follow; returns 0.
extern "C" int ssr_int8_set_pdl(int on) {
  g_pdl = on != 0;
  return 0;
}

// Blocks of the streaming kernel an SM holds at once for B rows in a mode
// (int8: 1, bf16: 0), into *blocks.
extern "C" int ssr_int8_stream_occupancy(int int8_mode, int B, int* blocks) {
  const int G = stream_groups(B);
  if (int8_mode) {
    return G == 1 ? occupancy<true, 1>(blocks) : G == 2 ? occupancy<true, 2>(blocks)
           : G == 4 ? occupancy<true, 4>(blocks) : occupancy<true, kMaxGroups>(blocks);
  }
  return G == 1 ? occupancy<false, 1>(blocks) : G == 2 ? occupancy<false, 2>(blocks)
         : G == 4 ? occupancy<false, 4>(blocks) : occupancy<false, kMaxGroups>(blocks);
}

// The edges of a CUDA graph, and how many of them are programmatic (a kernel
// node's programmatic port: what a launch with programmatic dependent launch
// becomes when it is captured), into *edges and *programmatic.
extern "C" int ssr_graph_programmatic_edges(void* graph, int* edges, int* programmatic) {
  auto g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (e != cudaSuccess) return e;
  cudaGraphNode_t* from = new cudaGraphNode_t[n + 1];
  cudaGraphNode_t* to = new cudaGraphNode_t[n + 1];
  cudaGraphEdgeData* data = new cudaGraphEdgeData[n + 1];
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, from, to, data, &n);
#else
  e = cudaGraphGetEdges_v2(g, from, to, data, &n);
#endif
  int prog = 0;
  for (size_t i = 0; e == cudaSuccess && i < n; ++i)
    prog += data[i].type == cudaGraphDependencyTypeProgrammatic;
  delete[] from;
  delete[] to;
  delete[] data;
  *edges = static_cast<int>(n);
  *programmatic = prog;
  return e;
}

// grid_request <= 0: one block per tile, at most what the device holds at
// once. A request above that is refused (cudaErrorCooperativeLaunchTooLarge):
// grid.sync() needs every block resident. *grid_used reports the grid.
extern "C" int ssr_int8_mega_bf16(const void* x, const void* w, const void* scale,
                                  void* h, void* out, int B, int L, int K, int N,
                                  int grid_request, int* grid_used, void* stream) {
  if (int e = check_shapes(B, K, N, 16, kRows)) return e;
  if (L < 1 || N < K) return cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_bf16_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const int resident = per_sm * sms;
  const int tiles = N / kTileN;
  const int grid = grid_request > 0 ? grid_request : (tiles < resident ? tiles : resident);
  if (grid_used) *grid_used = grid;
  if (grid < 1 || grid > resident) return cudaErrorCooperativeLaunchTooLarge;
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* hp = static_cast<float*>(h);
  uint16_t* op = static_cast<uint16_t*>(out);
  void* args[] = {&xp, &wp, &sp, &hp, &op, &B, &L, &K, &N};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mega_bf16_kernel),
                                     dim3(grid), dim3(kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
}
