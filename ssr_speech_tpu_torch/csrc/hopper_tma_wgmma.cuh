// Hopper (sm_90a) plumbing shared by the port's wgmma kernels: mbarriers, TMA
// tile loads, wgmma descriptors, fences and instruction wrappers, and the host
// side tensor-map encoder.
//
// Conventions used by every kernel that includes this header:
//  * Operand tiles live in shared memory as TMA writes them with the 128-byte
//    swizzle: a tile of R rows x 128 bf16 columns is two boxes of R rows x 64
//    columns (128 bytes a row), the second `R * 128` bytes after the first.
//    Tiles start on a 1024-byte boundary (the swizzle is a function of the
//    address), so descriptors carry base_offset 0.
//  * `desc_kmajor`: the reduction (k) dimension is the contiguous one, rows
//    are the M or N side. A 16-deep k step advances the start address by 32
//    bytes inside a box, and by a whole box after four steps.
//  * `desc_mnmajor`: the M/N dimension is the contiguous one and the rows are
//    the reduction dimension (the operand is stored transposed; wgmma's
//    trans-b bit). A 16-deep k step advances by 16 rows (2048 bytes); the
//    second 64 columns are one box further (the leading byte offset).
//  * Accumulators of m64nN: warp w of the warpgroup owns rows 16w..16w+15;
//    with g = lane / 4, t4 = lane % 4, d[4j + 0..1] are row g, columns
//    8j + 2t4 + {0, 1}, and d[4j + 2..3] the same columns of row g + 8: the
//    layout of mma.sync's C tiles, so two adjacent 8-column blocks are the A
//    fragment of one 16-deep step of the next product.
//  * Every mbarrier wait is bounded: a lost arrival traps (the launch then
//    fails at the next synchronise) instead of hanging the device.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssr {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// after the inits, before any thread or the TMA unit uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1u << 24)) __trap();
  }
}

// ----------------------------------------------------------------- cluster

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: after the barrier inits, before
// any block arrives on another's barriers. The blocks of a cluster are
// scheduled together, so only a fault (which ends the launch) can keep one away.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the barrier at `bar` (a shared::cta address of this kernel)
// in the block of rank `rank`. Its release is at CTA scope: one at cluster
// scope costs about a microsecond a call (measured on the dhidden kernel of
// fused_ce.cu, where it doubled the time), so a caller that hands shared
// memory to another block arrives only after its own loads of it have been
// consumed.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar), "r"(rank)
      : "memory");
}

// The address in the shared memory of the block of rank `rank` that `addr` (a
// shared::cta address of this kernel) has in this block.
__device__ __forceinline__ uint32_t mapa_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory (`remote` from mapa_shared),
// counted as complete_tx bytes on that block's barrier `remote_bar`: a thread
// waiting there sees the bytes once the phase completes, with no fence.
__device__ __forceinline__ void st_async_f32x4(uint32_t remote, float a, float b, float c,
                                               float d, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(remote_bar)
      : "memory");
}

// --------------------------------------------------------------------- TMA

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`. Rows outside the tensor
// arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

constexpr int kBoxCols = 64;  // bf16 columns of one box: 128 bytes, the swizzle width

// A [rows x 128] bf16 tile of head `bh` starting at row `r0`: two boxes.
__device__ __forceinline__ void tma_load_tile128(uint32_t dst, const CUtensorMap* map,
                                                 uint32_t bar, int r0, int bh, int rows) {
  tma_load_3d(dst, map, bar, 0, r0, bh);
  tma_load_3d(dst + rows * 128, map, bar, kBoxCols, r0, bh);
}

// ------------------------------------------------------------------- wgmma

constexpr uint32_t kSwizzleAtomBytes = 1024;  // 8 rows of 128 bytes

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}

// k step `kk` (16 bf16 of the 128 columns) of a [rows x 128] tile whose
// columns are the reduction dimension.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, kSwizzleAtomBytes);
}

// k step `kk` (16 rows) of a [rows x 128] tile whose rows are the reduction
// dimension and whose 128 columns are the N side.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 2 * kSwizzleAtomBytes, rows * 128, kSwizzleAtomBytes);
}

// k step `kk` (16 rows) of one box of R rows x 64 columns used as an A operand
// whose 64 columns are the M side and whose rows are the reduction dimension
// (wgmma's trans-a bit): one swizzle atom wide, so no leading offset.
__device__ __forceinline__ uint64_t desc_mnmajor_a64(uint32_t box, int kk) {
  return make_desc(box + kk * 2 * kSwizzleAtomBytes, kSwizzleAtomBytes, kSwizzleAtomBytes);
}

// k step `kk` (16 bf16 = 32 bytes, kk < 4) of one box of R rows x 64 columns
// whose columns are the reduction dimension; the rows are the M or N side, as
// many of them as the instruction is wide.
__device__ __forceinline__ uint64_t desc_kmajor_box(uint32_t box, int kk) {
  return make_desc(box + kk * 32, 16, kSwizzleAtomBytes);
}

// What to add to a descriptor to move its start address `bytes` (a multiple of
// 16) further, inside the 256 KB that the address field spans.
__device__ __forceinline__ uint64_t desc_step(int bytes) {
  return static_cast<uint64_t>(bytes >> 4);
}

// Byte offset of element (row, col) of a tile of 128-byte rows (64 bf16) that
// starts on a 1024-byte boundary, as the TMA unit's 128-byte swizzle stores it
// and a swizzled wgmma descriptor reads it: the 16-byte chunk index is xor-ed
// with the row's index mod 8.
__device__ __forceinline__ uint32_t swizzle128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// after ordinary stores to shared memory that a wgmma (or a TMA store) of
// another thread will read: makes them visible to the asynchronous proxy;
// follow it with the barrier that hands the tile over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// before the first wgmma, and after accumulator or A registers were written
// by ordinary instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulators between a wait and their first ordinary use, so the
// compiler moves no read of them above the wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments that an issued wgmma may still be reading: keeps
// their registers from being reused before the wait that follows the product
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The index of this thread's warpgroup, through a shuffle so that the compiler
// sees a warp-uniform value: the role branch on it is then one it can give
// separate register budgets (setmaxnreg below).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
}

// A barrier among the 128 threads of warpgroup `group` (hardware barrier
// group + 1; barrier 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_barrier(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

template <int Regs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory, both with
// the reduction dimension contiguous. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]: A from registers (the fragment of
// the header comment), B from shared memory stored [k][n] (trans-b).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]: as wgmma_m64n128k16_rs_tb, one box wide.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], both from shared memory, both with
// the reduction dimension contiguous. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 8] (+)= A[64 x 16] . B[16 x 8], as above: the first 8 rows of a B tile.
// D is the first 4 values of `d` (the first 8 columns of a wider accumulator).
template <int N>
__device__ __forceinline__ void wgmma_m64n8k16_ss(float (&d)[N], uint64_t a, uint64_t b,
                                                  int scale_d) {
  static_assert(N >= 4, "an m64n8 accumulator is 4 values a thread");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], both from shared memory. TransA /
// TransB == 0: the reduction dimension of that operand is the contiguous one
// (`desc_kmajor`); 1: its M / N dimension is (`desc_mnmajor_a64` for A).
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// -------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links no -lcuda
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map over a contiguous bf16 [planes, rows, cols] array (cols * 2 bytes a
// multiple of 16): boxes of `box_rows` rows x 64 columns of one plane, 128-byte
// swizzle; rows and columns outside the plane arrive as zeros. A map holds the
// array's address, so it is encoded for every launch.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int planes, int rows,
                                   int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t pitch = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {pitch, static_cast<cuuint64_t>(rows) * pitch};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The attention kernels' arrays: [heads, S, 128].
inline cudaError_t encode_heads_map(CUtensorMap* map, const void* base, int heads, int S,
                                    int box_rows) {
  return encode_rows_map(map, base, heads, S, 128, box_rows);
}

}  // namespace sm90
}  // namespace ssr
