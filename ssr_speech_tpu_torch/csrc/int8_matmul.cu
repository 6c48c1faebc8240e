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
//       chained layers in ONE launch; the first K columns of each layer's
//       output, rounded to bf16 (where the TPU kernel rounds its fp32 h for
//       each product: the same values), feed the next layer.
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
// - The megakernel (`mega_kernel`) is bound by the bytes
//   of all L layers (16 x 16.8 MB at the probe's widths, more than the L2
//   holds). Its first form separated layers with grid.sync() and read its
//   weights with per-thread loads, so the stream stopped at every layer; a
//   launch-per-layer chain loses the same time to ramps and drains. Here
//   one persistent grid (every block resident, checked before the launch)
//   streams every layer's weights without a break: stream_kernel's cluster
//   layout and products, the strips a cluster owns repeated for every
//   layer, and a producer warp a block that issues every tile by TMA into a
//   6-stage ring and waits only for free slots. Only the first K columns of
//   a layer feed the next, so only their strips publish: rank 0 stores its
//   columns of h as bf16 into the layer's own slot (no slot is reused, so no
//   reader races a writer) and adds to the layer's flag with release
//   semantics; the next layer's products start once one thread has acquired
//   the flag at its full count (bounded by %globaltimer, so a fault traps
//   instead of hanging). The other strips' work runs in the shadow of the
//   next flag. Every column of every layer is computed and every byte of w
//   is read, as on the TPU; the last layer's fp32 sums of all columns land in
//   a [B, N] scratch (the TPU kernel's acc_scr) that the tests read. Sums in
//   stream_kernel's fixed order, independent of the grid's size.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

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

namespace {

using ssr::bf16_bits;
using ssr::bf16_float;
using namespace ssr::sm90;

constexpr int kTileN = 64;  // N must be a multiple (the 16-byte stores of 8 columns a lane)

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
// K9: L layers in one persistent launch. A cluster of two blocks owns
// 128-column strips s = cluster, cluster + clusters, ... of every layer (the
// feedback strips, s * 128 < K, come first in a layer), the two splitting K
// by alternate stages as stream_kernel does; its 16 consumer warps compute as
// stream_kernel's one row group. A 17th warp issues every (layer, strip,
// stage) tile of the block by TMA, in the order the consumers take them, into
// a ring of kMegaStages: it waits only for free slots, never for h, so the
// next layer's weights arrive while this layer's dependency resolves.
// Layer l + 1 needs only h_{l+1} = y_l[:, :K]: rank 0 of a feedback strip
// stores its columns of it as bf16 into slot l of `hs` ([L - 1, 8, K]; the
// last layer into `out`), then adds 1 to flags[l] with release semantics;
// the consumers of layer l + 1 start once flags[l] counts every feedback
// strip (one thread acquires, bounded by %globaltimer). Every column's fp32
// sum of the last layer lands in `last` [B, N] (the TPU kernel's acc_scr).
// A feedback strip's four stages a block lie on the dependency chain; the
// other layout, every block one feedback stage a layer summed through L2 by
// the block that completes the strip, was twice as slow on the card (its sum
// took 7.5 us a layer, PERF.md). 17 warps leave a thread 96 registers; this
// body fits them without spilling, the two layouts in one did not.
constexpr int kMegaStages = 6;  // the ring (32 KB a stage): 1.5 layers of a block's K = 2048
constexpr int kMegaParts = kWideParts;               // 8 k-parts x 2 column halves
constexpr int kMegaConsumers = 2 * kMegaParts * 32;  // 16 warps
constexpr int kMegaThreads = kMegaConsumers + 32;    // and the producer warp
constexpr int kMegaVals = 16;                        // accumulators a thread: 8 rows
constexpr int kHRows = 8;                            // rows of an h slot
constexpr uint32_t kMegaSendBytes = 2 * kMegaVals * 32 * 4;  // rank 1's two warps' sums
constexpr int kMegaXStages = 4;  // stages of h a block stages in shared memory at once
// h of kMegaXStages stages, [stage][8 rows][256 columns] bf16, rows padded by
// 16 bytes so that the 8 rows a warp's lanes read meet no bank conflict
constexpr int kHPitch = kStageRows * 2 + 16;
constexpr int kHStageBytes = kMegaXStages * kHRows * kHPitch;
// the tree's buffer, which the staged h shares (they are never live at once)
constexpr int kMegaRedBytes =
    (kMegaParts / 2) * 2 * kMegaVals * 32 * 4 > kHStageBytes ? (kMegaParts / 2) * 2 * kMegaVals * 32 * 4
                                                              : kHStageBytes;
constexpr unsigned long long kFlagTimeoutNs = 2000000000ull;
// the ring, the tree's buffer, two receive buffers, the barriers, the slack
// to align the ring to 1024 bytes
constexpr size_t mega_smem() {
  return kMegaStages * kStageBytes + kMegaRedBytes + 2 * kMegaSendBytes +
         8 * (2 * kMegaStages + 4) + 1024;
}

#ifndef SSR_INT8_TIMES  // tools/torch_int8_cycles.py: thread 0's phases a layer
#define SSR_MEGA_MARK(layer, slot)
#define SSR_MEGA_ISSUE(layer)
#endif

// a barrier among `threads` threads (whole warps) on hardware barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// returns once *flag >= target (acquire at GPU scope); traps after 2 s, so a
// lost publication fails the launch instead of hanging the device
__device__ __forceinline__ void wait_flag(const int* flag, int target) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
    if (v >= target) return;
    if (global_ns() - t0 > kFlagTimeoutNs) __trap();
  }
}

// *flag += 1, releasing at GPU scope every write that happens before it
__device__ __forceinline__ void publish(int* flag) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag) : "memory");
}

template <bool kStreamOnly>
__global__ void __launch_bounds__(kMegaThreads, 1)
mega_kernel(const __grid_constant__ CUtensorMap wmap, const uint16_t* x, uint16_t* hs,
            uint16_t* out, float* last, const float* __restrict__ scale, int* flags, int B,
            int L, int K, int N) {
  constexpr int kStep = 16;                        // k-rows of one mma
  constexpr int kMine = kStageRows / kStep / kMegaParts;  // k-steps of a stage a warp takes
  extern __shared__ uint8_t smem_raw[];
  SSR_BEGIN();
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - base);
  const uint32_t red = ring + kMegaStages * kStageBytes;
  const uint32_t recv = red + kMegaRedBytes;              // [2][kMegaSendBytes]
  const uint32_t full = recv + 2 * kMegaSendBytes;        // [kMegaStages]
  const uint32_t empty = full + 8 * kMegaStages;          // [kMegaStages]
  const uint32_t recv_full = empty + 8 * kMegaStages;     // [2], rank 0's
  const uint32_t recv_empty = recv_full + 16;             // [2], rank 1's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int strips = (N + kStripN - 1) / kStripN;
  const int feedback = (K + kStripN - 1) / kStripN;  // strips with columns < K
  const int T = (K + kStageRows - 1) / kStageRows;
  const int Tr = (T - static_cast<int>(rank) + kCluster - 1) / kCluster;  // this block's
  auto stage_k = [&](int u) {  // the first k-row of this block's stage u of a strip
    return (kCluster * u + static_cast<int>(rank)) * kStageRows;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMegaStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kMegaConsumers / 32);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(recv_full + 8 * j, 1);
      mbar_init(recv_empty + 8 * j, 1);
    }
    mbar_fence_init();
    if (rank == 0)
      for (int j = 0; j < 2; ++j) mbar_arrive_expect_tx(recv_full + 8 * j, kMegaSendBytes);
  }
  __syncthreads();
  cluster_sync();  // the barriers of both blocks are ready

  if (warp == kMegaConsumers / 32) {
    // the producer: every tile of the block in the consumers' order
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      int t = 0;
      for (int l = 0; l < L; ++l)
        for (int s = cluster; s < strips; s += clusters)
          for (int u = 0; u < Tr; ++u, ++t) {
            const int slot = t % kMegaStages;
            if (t >= kMegaStages) mbar_wait(empty + 8 * slot, ((t / kMegaStages) - 1) & 1);
            if (s == cluster && u == 0) SSR_MEGA_ISSUE(l);
            mbar_arrive_expect_tx(full + 8 * slot, kStageBytes);
            tma_load_3d(ring + slot * kStageBytes, &wmap, full + 8 * slot, s * kStripN,
                        stage_k(u), l);
          }
    }
    __syncwarp();
  } else if (cluster < strips) {
    const int g = lane >> 2, q = lane & 3;
    const int half = warp & 1, part = warp >> 1;
    // this lane's byte offsets in a k-step of a stage, as stream_kernel's
    uint32_t roff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 2 * q + (i & 1) + 8 * (i >> 1);
      roff[i] = row * kStripN + ((((half * 4 + (g >> 1)) ^ row) & 7) << 4) + (g & 1) * 8;
    }
    float* red_ptr = reinterpret_cast<float*>(smem_raw + (red - base));
    uint8_t* xs_ptr = smem_raw + (red - base);  // the staged h, in the tree's buffer
    const float* recv_ptr = reinterpret_cast<const float*>(smem_raw + (recv - base));
    const bool xok = g < B;  // batch row g of the products
    int t = 0, item = 0;     // tiles and (layer, strip) items taken so far
    for (int l = 0; l < L; ++l) {
      SSR_MEGA_MARK(l, 0);
      if (!kStreamOnly && l > 0) {  // h_l is in place once every feedback strip is
        if (threadIdx.x == 0) wait_flag(flags + l - 1, feedback);
        named_sync(1, kMegaConsumers);
      }
      SSR_MEGA_MARK(l, 1);
      const uint16_t* src = l == 0 ? x : hs + static_cast<size_t>(l - 1) * kHRows * K;
      uint16_t* dst = l == L - 1 ? out : hs + static_cast<size_t>(l) * kHRows * K;
      for (int s = cluster; s < strips; s += clusters, ++item) {
        const int n0 = s * kStripN;
        const int c0 = n0 + 64 * warp + 8 * g;  // the columns this lane stores (rank 0, warps 0-1)
        const bool stores = !kStreamOnly && rank == 0 && warp < 2 && c0 < N;
        float sc[8];
        if (stores) {  // needs nothing computed: read before the products
          const float4 sa = __ldg(reinterpret_cast<const float4*>(scale + static_cast<size_t>(l) * N + c0));
          const float4 sb = __ldg(reinterpret_cast<const float4*>(scale + static_cast<size_t>(l) * N + c0 + 4));
          sc[0] = sa.x; sc[1] = sa.y; sc[2] = sa.z; sc[3] = sa.w;
          sc[4] = sb.x; sc[5] = sb.y; sc[6] = sb.z; sc[7] = sb.w;
        }
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        for (int u0 = 0; u0 < Tr; u0 += kMegaXStages) {
          // h's columns of up to kMegaXStages stages: the block copies them
          // from L2 into shared memory, 16 bytes a thread and load (one trip,
          // whole sectors, each byte once a block), then a warp takes its
          // words: row g, k0 + 2q + {0, 1}, k0 + 8 + 2q + {0, 1}
          uint32_t xw[kMegaXStages][kMine][2];
          if (!kStreamOnly) {
            constexpr int kChunks = kStageRows * 2 / 16;  // 16-byte chunks of a row's stage
            constexpr int kPer = kMegaXStages * kHRows * kChunks / kMegaConsumers;
            static_assert(kPer * kMegaConsumers == kMegaXStages * kHRows * kChunks, "whole chunks");
            uint4 hv[kPer];
            bool hok[kPer];
#pragma unroll
            for (int i = 0; i < kPer; ++i) {  // every load before any store
              const int v = threadIdx.x + i * kMegaConsumers;
              const int du = v / (kHRows * kChunks), row = (v / kChunks) % kHRows;
              const int k = stage_k(u0 + du) + (v % kChunks) * 8;
              hok[i] = row < B && u0 + du < Tr && k < K;
              if (hok[i]) hv[i] = __ldcg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * K + k));
            }
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const int v = threadIdx.x + i * kMegaConsumers;
              if (hok[i])
                *reinterpret_cast<uint4*>(xs_ptr + (v / kChunks) * kHPitch + (v % kChunks) * 16) = hv[i];
            }
            named_sync(1, kMegaConsumers);
#pragma unroll
            for (int du = 0; du < kMegaXStages; ++du)
#pragma unroll
              for (int m = 0; m < kMine; ++m) {
                const int kl = (part + m * kMegaParts) * kStep + 2 * q;  // in the stage
                const uint8_t* p = xs_ptr + (du * kHRows + g) * kHPitch + kl * 2;
                xw[du][m][0] = xok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
                xw[du][m][1] = xok ? *reinterpret_cast<const uint32_t*>(p + 16) : 0u;
              }
            named_sync(1, kMegaConsumers);  // every warp has its words: the buffer is free
          }
#pragma unroll
          for (int du = 0; du < kMegaXStages; ++du) {
            if (u0 + du >= Tr) break;
            const int slot = t % kMegaStages;
            mbar_wait(full + 8 * slot, (t / kMegaStages) & 1);
            if (!kStreamOnly) {
              const uint8_t* stage = ring_ptr + slot * kStageBytes;
              const int kbase = stage_k(u0 + du);
#pragma unroll
              for (int m = 0; m < kMine; ++m) {
                const int step = part + m * kMegaParts;
                if (kbase + step * kStep < K) {  // warp-uniform; K is a multiple of kStep
                  const uint8_t* sp = stage + step * kStep * kStripN;
                  uint2 r[4];
#pragma unroll
                  for (int i = 0; i < 4; ++i) r[i] = *reinterpret_cast<const uint2*>(sp + roff[i]);
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    uint32_t a[4];
                    a[0] = pair_bf16(r[0].x, r[1].x, j);
                    a[1] = pair_bf16(r[0].y, r[1].y, j);
                    a[2] = pair_bf16(r[2].x, r[3].x, j);
                    a[3] = pair_bf16(r[2].y, r[3].y, j);
                    mma_bf16(acc[j], a, xw[du][m][0], xw[du][m][1]);
                  }
                }
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp is done with it
            ++t;
            if (u0 + du == 0) SSR_MEGA_MARK(l, 2);
          }
        }
        if (kStreamOnly) continue;
        SSR_MEGA_MARK(l, 3);
        // the k-parts' partials, 8 -> 4 -> 2 -> 1 in one fixed order (part i
        // += part i + h), through the tree's own buffer
#pragma unroll
        for (int h2 = kMegaParts / 2; h2 >= 1; h2 /= 2) {
          if (part >= h2 && part < 2 * h2) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                red_ptr[(((part - h2) * 2 + half) * kMegaVals + j * 4 + c) * 32 + lane] = acc[j][c];
          }
          named_sync(1, kMegaConsumers);
          if (part < h2) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[j][c] += red_ptr[((part * 2 + half) * kMegaVals + j * 4 + c) * 32 + lane];
          }
          named_sync(1, kMegaConsumers);
        }
        SSR_MEGA_MARK(l, 4);
        if (warp >= 2) continue;
        // the cluster's sum: rank 1's warps 0-1 push theirs into receive
        // buffer item % 2 of rank 0 (counted on its barrier), once rank 0
        // has taken what was there two items before; rank 0 adds them after
        // its own, scales, stores, and publishes a feedback strip
        const int rb = item & 1;
        const uint32_t phase = (item >> 1) & 1;
        if (rank == 1) {
          if (item >= 2) mbar_wait(recv_empty + 8 * rb, phase ^ 1);
          const uint32_t dst_buf = mapa_shared(recv + rb * kMegaSendBytes, 0);
          const uint32_t bar = mapa_shared(recv_full + 8 * rb, 0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            st_async_f32x4(dst_buf + ((warp * 4 + j) * 32 + lane) * 16, acc[j][0], acc[j][1],
                           acc[j][2], acc[j][3], bar);
          continue;
        }
        mbar_wait(recv_full + 8 * rb, phase);
        const float* got = recv_ptr + rb * (kMegaSendBytes / 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] += got[((warp * 4 + j) * 32 + lane) * 4 + c];
        named_sync(2, 64);  // both warps have read the buffer
        if (threadIdx.x == 0) {
          mbar_arrive_expect_tx(recv_full + 8 * rb, kMegaSendBytes);  // for item + 2
          mbar_arrive_remote(recv_empty + 8 * rb, 1);
        }
        SSR_MEGA_MARK(l, 5);
        if (stores) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 2 * q + h;
            if (row >= B) continue;
            float y[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) y[c] = (c < 4 ? acc[c][h] : acc[c - 4][2 + h]) * sc[c];
            if (c0 < K) {  // K is a multiple of 16: all 8 columns feed back or none
              uint32_t packed[4];
#pragma unroll
              for (int pp = 0; pp < 4; ++pp)
                packed[pp] = static_cast<uint32_t>(bf16_bits(y[2 * pp])) |
                             static_cast<uint32_t>(bf16_bits(y[2 * pp + 1])) << 16;
              *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * K + c0) =
                  make_uint4(packed[0], packed[1], packed[2], packed[3]);
            }
            if (l == L - 1) {
              float4* lp = reinterpret_cast<float4*>(last + static_cast<size_t>(row) * N + c0);
              lp[0] = make_float4(y[0], y[1], y[2], y[3]);
              lp[1] = make_float4(y[4], y[5], y[6], y[7]);
            }
          }
        }
        if (n0 < K) {  // a feedback strip: h's columns of it are stored
          named_sync(2, 64);
          if (threadIdx.x == 0) publish(flags + l);
        }
        SSR_MEGA_MARK(l, 6);
      }
    }
  }
  __syncwarp();
  cluster_sync();  // neither block leaves while the other may still signal it
  SSR_END();
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

template <bool kStreamOnly>
int launch_mega(const void* x, const void* w, const void* scale, void* hs, void* flags,
                void* last, void* out, int B, int L, int K, int N, int grid_request,
                int* grid_used, cudaStream_t stream) {
  if (grid_used) *grid_used = 0;
  if (int e = check_shapes(B, K, N, 16, kHRows)) return e;
  if (L < 1 || N < K || grid_request < 0 || grid_request % kCluster) return cudaErrorInvalidValue;
  auto kernel = mega_kernel<kStreamOnly>;
  // also the runtime call that makes the context current before the encode
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(mega_smem()));
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = encode_int8_planes_map(&map, w, L, K, N, kStageRows);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  const int strips = (N + kStripN - 1) / kStripN;
  cfg.gridDim = dim3(kCluster * strips);
  cfg.blockDim = dim3(kMegaThreads);
  cfg.dynamicSmemBytes = mega_smem();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // every block spins on flags that other blocks raise: the whole grid must
  // be resident at once, so it is at most what the device holds
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  const int resident = kCluster * clusters;
  const int grid = grid_request > 0 ? grid_request : (kCluster * strips < resident ? kCluster * strips : resident);
  if (grid_used) *grid_used = grid;
  if (grid < kCluster || grid > resident) return cudaErrorCooperativeLaunchTooLarge;
  cfg.gridDim = dim3(grid);
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const uint16_t*>(x),
                         static_cast<uint16_t*>(hs), static_cast<uint16_t*>(out),
                         static_cast<float*>(last), static_cast<const float*>(scale),
                         static_cast<int*>(flags), B, L, K, N);
  return e != cudaSuccess ? e : cudaGetLastError();
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

// K9: x bf16 [B, K] (B <= 8), w int8 [L, K, N], scale fp32 [L, 1, N]; hs bf16
// [max(L - 1, 1), 8, K] scratch (h of layers 1 .. L - 1), flags int32 [L]
// ZEROED before the launch, last fp32 [B, N] (the last layer's sums), out bf16
// [B, K]. grid_request 0: two blocks a strip, at most what the device holds at
// once; otherwise an even grid, refused (cudaErrorCooperativeLaunchTooLarge)
// above that. *grid_used reports the grid.
extern "C" int ssr_int8_mega_bf16(const void* x, const void* w, const void* scale, void* hs,
                                  void* flags, void* last, void* out, int B, int L, int K,
                                  int N, int grid_request, int* grid_used, void* stream) {
  return launch_mega<false>(x, w, scale, hs, flags, last, out, B, L, K, N, grid_request,
                            grid_used, static_cast<cudaStream_t>(stream));
}

// The megakernel's weight stream alone: the same grid, ring and tiles, every
// stage waited for and released with no products, no h and no flags (a
// measurement of the rate the stream reaches; it writes nothing).
extern "C" int ssr_int8_mega_stream(const void* w, int L, int K, int N, int grid_request,
                                    int* grid_used, void* stream) {
  return launch_mega<true>(nullptr, w, nullptr, nullptr, nullptr, nullptr, nullptr, kHRows, L,
                           K, N, grid_request, grid_used, static_cast<cudaStream_t>(stream));
}

// The largest grid of the megakernel the device holds at once, into *blocks.
extern "C" int ssr_int8_mega_resident(int* blocks) {
  auto kernel = mega_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(mega_smem()));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kMegaThreads);
  cfg.dynamicSmemBytes = mega_smem();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *blocks = kCluster * clusters;
  return e;
}
