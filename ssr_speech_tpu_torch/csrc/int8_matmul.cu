// Int8 weight-streaming matvecs for Hopper (sm_90a): a few activation rows
// against an int8 weight matrix with one fp32 scale per output column.
//
// Replaces the three Pallas TPU kernels of the int8 decode probes:
//
//   ssr_int8_matvec_f32    <- tools/int8_matmul.py `_kernel` (int8_matmul):
//       y[b,n] = (sum_k x[b,k] * float(w[k,n])) * scale[n], the weight
//       dequantised to fp32 in registers and an fp32 dot;
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
// x is bf16 [B, K] with B <= 8 (row pitch ldx elements), w int8 [K, N] with N
// contiguous, scale fp32 [N], out bf16 [B, N].
//
// What bounds them: bytes. With 2 or 8 rows a layer does 2*B*K*N operations on
// K*N weight bytes, far below the card's operations-per-byte ridge, so the
// least time is the weight's bytes over the memory rate and the design only
// has to keep enough loads in flight and stay off the critical path with its
// arithmetic:
//
// - One block owns a 64-column tile of the output and all of K, split over 16
//   warps (rows k interleaved between the warps), so a [2048, 8192] layer is
//   128 blocks on the card's 132 SMs and every weight byte is read once.
// - The two tensor-core kernels make the WEIGHT the A operand of mma.sync
//   (16 output columns x k) and the activations the B operand (k x 8 batch
//   rows): the 8-wide N of the instruction is exactly the batch, so no
//   accumulator is wasted on padding rows. A lane (g = lane / 4, q = lane % 4)
//   loads 8 bytes (columns n0 + 8g .. 8g+7) from each of its 4 (bf16) or 8
//   (int8) rows of a k-step, so the warp's loads cover whole 64-byte row
//   segments; the instruction's k index is permuted so that a lane's rows are
//   consecutive, the same permutation on both operands. w is [K, N] with N
//   contiguous while the fragments want consecutive k per column, so bytes are
//   gathered in registers (`prmt`): for bf16 each byte becomes a float through
//   the 2^23 magic number and the upper halves are packed; for int8 a 4x4
//   byte transpose builds the k-quads. No repacked copy of w is needed.
// - The fp32 kernel runs on the CUDA cores (the TPU kernel's dot is fp32): x is
//   staged once in shared memory as fp32, a half-warp reads 64 bytes of one
//   row (4 columns a lane), the other half the next row.
// - Partial sums of the 16 warps meet in shared memory and are added in warp
//   order: no float atomics, so two runs repeat bit for bit; the int8 mode's
//   int32 sums are exact in any order.
// - The megakernel is a persistent cooperative grid (one block per tile, at
//   most what is co-resident): layers are separated by grid.sync(), h is
//   double-buffered in global memory as fp32 [2, 8, K] (32 KB a buffer: it
//   lives in L2) and read back with ld.global.cg, which bypasses the
//   non-coherent L1. Every column of every layer is computed and every byte
//   of w is read, as on the TPU; only the first K columns are fed back.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace cg = cooperative_groups;

namespace {

using ssr::bf16_bits;
using ssr::bf16_float;
using ssr::mma_16816;
using ssr::pack_bf16;

constexpr int kTileN = 64;    // output columns per block
constexpr int kWarps = 16;    // K is split over the warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;      // batch rows the tensor-core kernels carry
constexpr int kRed = kWarps * kRows * kTileN;  // partial sums, 4 bytes each

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

// D = A.B + D for one 16x8x32 tile of int8 (int32 accumulate).
__device__ __forceinline__ void mma_16832_s8(int* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(32 x), +-127) as an int8 byte (rint rounds half to even).
__device__ __forceinline__ uint32_t quant_byte(uint16_t bf16) {
  const float t = fminf(fmaxf(rintf(bf16_float(bf16) * 32.0f), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(t)) & 0xFFu;
}

// ------------------------------------------------------------ bf16 products
//
// One warp's share of a 64-column tile: rows k0 + 4q + {0..3} of every 16-row
// step it owns. acc[j] is the C fragment of mma j, whose 16 A rows are the
// columns n0 + 8g + j (rows 0-7) and n0 + 8g + j + 4 (rows 8-15):
//   acc[j][0], [1] = y[2q], y[2q+1] at column 8g + j
//   acc[j][2], [3] = y[2q], y[2q+1] at column 8g + j + 4
// kF32: the activations are fp32 rows written by other blocks (read through
// L2 and rounded to bf16 here); else bf16 rows.
template <bool kF32>
__device__ __forceinline__ void warp_tile_bf16(const int8_t* __restrict__ w,
                                               const void* x, int ldx, int B,
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
      if (kF32) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            static_cast<const float*>(x) + static_cast<size_t>(g) * ldx + k));
        b0 = pack_bf16(v.x, v.y);
        b1 = pack_bf16(v.z, v.w);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(
            static_cast<const uint16_t*>(x) + static_cast<size_t>(g) * ldx + k);
        b0 = v.x;
        b1 = v.y;
      }
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

__global__ void __launch_bounds__(kThreads)
matvec_bf16_kernel(const uint16_t* __restrict__ x, int ldx,
                   const int8_t* __restrict__ w, const float* __restrict__ scale,
                   uint16_t* __restrict__ out, int B, int K, int N) {
  __shared__ float red[kRed];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kTileN;
  float acc[4][4];
  warp_tile_bf16<false>(w, x, ldx, B, K, N, n0, warp, lane, acc);
  store_partials<float>(red, warp, lane, acc);
  __syncthreads();
  for (int o = threadIdx.x; o < B * kTileN; o += kThreads) {
    const int b = o / kTileN, c = o % kTileN;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[(wi * kRows + b) * kTileN + c];
    out[static_cast<size_t>(b) * N + n0 + c] = bf16_bits(sum * scale[n0 + c]);
  }
}

// ------------------------------------------------------------ int8 products
//
// Rows k0 + 8q + {0..7} of every 32-row step; the A fragment of mma j is the
// byte-transposed quads of columns 8g + j (rows 0-7 of A) and 8g + j + 4.
__global__ void __launch_bounds__(kThreads)
matvec_int8_kernel(const uint16_t* __restrict__ x, int ldx,
                   const int8_t* __restrict__ w, const float* __restrict__ scale,
                   uint16_t* __restrict__ out, int B, int K, int N) {
  __shared__ int red[kRed];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * kTileN;
  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const int8_t* wp = w + n0 + g * 8;
#pragma unroll 2
  for (int k0 = warp * 32; k0 < K; k0 += kWarps * 32) {
    const int k = k0 + 8 * q;
    uint2 r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(k + i) * N));
    uint32_t b0 = 0, b1 = 0;
    if (g < B) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(g) * ldx + k);
      b0 = quant_byte(v.x & 0xFFFF) | quant_byte(v.x >> 16) << 8 |
           quant_byte(v.y & 0xFFFF) << 16 | quant_byte(v.y >> 16) << 24;
      b1 = quant_byte(v.z & 0xFFFF) | quant_byte(v.z >> 16) << 8 |
           quant_byte(v.w & 0xFFFF) << 16 | quant_byte(v.w >> 16) << 24;
    }
    uint32_t lo03[4], hi03[4], lo47[4], hi47[4];
    transpose4(r[0].x, r[1].x, r[2].x, r[3].x, lo03);
    transpose4(r[0].y, r[1].y, r[2].y, r[3].y, hi03);
    transpose4(r[4].x, r[5].x, r[6].x, r[7].x, lo47);
    transpose4(r[4].y, r[5].y, r[6].y, r[7].y, hi47);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {lo03[j], hi03[j], lo47[j], hi47[j]};
      mma_16832_s8(acc[j], a, b0, b1);
    }
  }
  store_partials<int>(red, warp, lane, acc);
  __syncthreads();
  for (int o = threadIdx.x; o < B * kTileN; o += kThreads) {
    const int b = o / kTileN, c = o % kTileN;
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[(wi * kRows + b) * kTileN + c];
    const float y = (static_cast<float>(sum) * (1.0f / 32.0f)) * scale[n0 + c];
    out[static_cast<size_t>(b) * N + n0 + c] = bf16_bits(y);
  }
}

// ------------------------------------------------------------ fp32 products
//
// R = 2 or 8 rows of x (rows past B are zero). A half-warp reads 64 bytes of
// one weight row, 4 columns a lane; the two halves take neighbouring rows.
// Shared memory: xs[R][K] fp32, then red[kWarps][R][64].
template <int R>
__global__ void __launch_bounds__(kThreads)
matvec_f32_kernel(const uint16_t* __restrict__ x, int ldx,
                  const int8_t* __restrict__ w, const float* __restrict__ scale,
                  uint16_t* __restrict__ out, int B, int K, int N) {
  extern __shared__ __align__(16) float smem_f32[];
  float* xs = smem_f32;
  float* red = smem_f32 + R * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, c4 = (lane & 15) * 4;
  const int n0 = blockIdx.x * kTileN;
  for (int i = threadIdx.x; i < R * K; i += kThreads) {
    const int r = i / K, k = i % K;
    xs[i] = r < B ? bf16_float(x[static_cast<size_t>(r) * ldx + k]) : 0.f;
  }
  __syncthreads();
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  const int8_t* wp = w + n0 + c4;
#pragma unroll 8
  for (int k = 2 * warp + half; k < K; k += 2 * kWarps) {
    const uint32_t word =
        __ldg(reinterpret_cast<const uint32_t*>(wp + static_cast<size_t>(k) * N)) ^
        0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = byte_to_float(word, j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = xs[r * K + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
      if (half == 0) red[(warp * R + r) * kTileN + c4 + j] = acc[r][j];
    }
  __syncthreads();
  for (int o = threadIdx.x; o < B * kTileN; o += kThreads) {
    const int b = o / kTileN, c = o % kTileN;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[(wi * R + b) * kTileN + c];
    out[static_cast<size_t>(b) * N + n0 + c] = bf16_bits(sum * scale[n0 + c]);
  }
}

// -------------------------------------------------------------- megakernel
//
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
      warp_tile_bf16<true>(wl, src, K, B, K, N, n0, warp, lane, acc);
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

int check_shapes(int B, int K, int N, int kstep) {
  if (B < 1 || B > kRows || K < kstep || K % kstep || N < kTileN || N % kTileN)
    return cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Every entry point returns 0 or the CUDA error of its launch; nothing here
// synchronises or allocates.

extern "C" int ssr_int8_matvec_f32(const void* x, int ldx, const void* w,
                                   const void* scale, void* out, int B, int K,
                                   int N, void* stream) {
  if (int e = check_shapes(B, K, N, 2 * kWarps)) return e;
  const int R = B <= 2 ? 2 : kRows;
  const size_t smem = (static_cast<size_t>(R) * K + kWarps * R * kTileN) * sizeof(float);
  auto kernel = B <= 2 ? matvec_f32_kernel<2> : matvec_f32_kernel<kRows>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<N / kTileN, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), ldx, static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<uint16_t*>(out), B, K, N);
  return cudaGetLastError();
}

extern "C" int ssr_int8_matvec_bf16(const void* x, int ldx, const void* w,
                                    const void* scale, void* out, int B, int K,
                                    int N, void* stream) {
  if (int e = check_shapes(B, K, N, 16)) return e;
  matvec_bf16_kernel<<<N / kTileN, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), ldx, static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<uint16_t*>(out), B, K, N);
  return cudaGetLastError();
}

extern "C" int ssr_int8_matvec_int8(const void* x, int ldx, const void* w,
                                    const void* scale, void* out, int B, int K,
                                    int N, void* stream) {
  if (int e = check_shapes(B, K, N, 32)) return e;
  matvec_int8_kernel<<<N / kTileN, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), ldx, static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<uint16_t*>(out), B, K, N);
  return cudaGetLastError();
}

// grid_request <= 0: one block per tile, at most what the device holds at
// once. A request above that is refused (cudaErrorCooperativeLaunchTooLarge):
// grid.sync() needs every block resident. *grid_used reports the grid.
extern "C" int ssr_int8_mega_bf16(const void* x, const void* w, const void* scale,
                                  void* h, void* out, int B, int L, int K, int N,
                                  int grid_request, int* grid_used, void* stream) {
  if (int e = check_shapes(B, K, N, 16)) return e;
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
