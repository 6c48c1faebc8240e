// Tensor-core fragment helpers shared by the port's hand-written kernels.
//
// Every product runs through `mma.sync.aligned.m16n8k16` (bf16 in, fp32
// accumulate). For one warp, with g = lane / 4 and t4 = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t4..2t4+1],   a1 = A[g+8][2t4..],
//                         a2 = A[g][2t4+8..],      a3 = A[g+8][2t4+8..]
//   B (16x8):             b0 = B[2t4..2t4+1][g],   b1 = B[2t4+8..2t4+9][g]
//   C (16x8, fp32):       c0,c1 = C[g][2t4..],     c2,c3 = C[g+8][2t4..]
// so the accumulators of two adjacent 8-column C tiles are exactly the A
// fragment of one 16-deep step: a product's output can feed the next product
// without leaving registers.
//
// Shared-memory tiles are bf16 (stored as uint16_t) with a row pitch in
// elements; pitches are even so every 32-bit load is aligned.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace ssr {

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  __nv_bfloat16 v = __float2bfloat16_rn(x);
  uint16_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

__device__ __forceinline__ float bf16_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// D = A.B + D for one 16x8x16 tile.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A[m0.., k0..] from a tile stored as s[m][k].
__device__ __forceinline__ void load_a(uint32_t* a, const uint16_t* s, int pitch,
                                       int m0, int k0, int g, int t4) {
  const uint16_t* p = s + (m0 + g) * pitch + k0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// A[m0.., k0..] from a tile stored transposed, as s[k][m].
__device__ __forceinline__ void load_a_t(uint32_t* a, const uint16_t* s, int pitch,
                                         int m0, int k0, int g, int t4) {
  const uint16_t* p = s + (k0 + t4 * 2) * pitch + m0 + g;
  a[0] = pack2(p[0], p[pitch]);
  a[1] = pack2(p[8], p[pitch + 8]);
  a[2] = pack2(p[8 * pitch], p[9 * pitch]);
  a[3] = pack2(p[8 * pitch + 8], p[9 * pitch + 8]);
}

// B[k0.., n0..] from a tile stored as s[n][k] (B transposed, row-major).
__device__ __forceinline__ void load_b_nk(uint32_t* b, const uint16_t* s, int pitch,
                                          int k0, int n0, int g, int t4) {
  const uint16_t* p = s + (n0 + g) * pitch + k0 + t4 * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B[k0.., n0..] from a tile stored as s[k][n].
__device__ __forceinline__ void load_b_kn(uint32_t* b, const uint16_t* s, int pitch,
                                          int k0, int n0, int g, int t4) {
  const uint16_t* p = s + (k0 + t4 * 2) * pitch + n0 + g;
  b[0] = pack2(p[0], p[pitch]);
  b[1] = pack2(p[8 * pitch], p[9 * pitch]);
}

}  // namespace ssr
