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
// Inputs: hidden bf16 [K, N, Hh], w2 bf16 [K, Hh, C], b2 bf16 [K, C],
// targets int32 [K, N]; Hh a multiple of 128 up to 1024, any N and C. The vocab
// tail is masked by bounds, so columns past C never enter logz or the rank
// (the TPU kernel pads them with a -1e9 bias instead).
//
// Design (simple first). The TPU kernel holds a [128, Cp] fp32 logits block
// in VMEM; that does not fit Hopper's shared memory, and the rank needs the
// target logit before it can count. Here a block of 8 warps owns 32 rows and
// keeps their hidden rows in shared memory; vocab tiles of 32 columns of w2
// are staged beside them, and each warp computes a 16x8 piece of the 32x32
// logits tile with mma.sync m16n8k16 (bf16 in, fp32 out).
//  * forward: two passes over the vocab tiles, the first for the online
//    max/sum and the target logit, the second for the rank count; one thread
//    per row reduces each tile in column order (deterministic).
//  * dhidden: one pass; the tile's bf16 dlogits go through shared memory into
//    a second product against the same w2 tile, dhidden accumulating in
//    registers (each warp owns Hh/8 of the hidden columns).
//  * dw2/db2: a block owns (k, vocab tile) and loops over all row blocks, so
//    dw2 (each warp owns Hh/8 of its rows) and db2 accumulate in fp32 without
//    atomics, in a fixed order.
// At the 830M shapes (K = 4, N ~ 8e3-2e4, Hh = 1024, C = 2056) each pass is
// 2*K*N*Hh*C flops on the tensor cores; the staged tiles are re-read from L2
// (w2 once per row block, hidden once per vocab tile in dw2). What it leaves on
// the table: wgmma, TMA double-buffering of the w2 tiles, larger row blocks.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace {

using namespace ssr;

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

__host__ __device__ constexpr size_t fwd_smem(int hh) {
  return static_cast<size_t>(kRows) * h_pitch(hh) * sizeof(uint16_t) +
         static_cast<size_t>(hh) * kWPitch * sizeof(uint16_t) + kRows * (kVt + 1) * sizeof(float);
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

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const uint16_t* __restrict__ hidden, const uint16_t* __restrict__ w2,
              const uint16_t* __restrict__ b2, const int* __restrict__ targets,
              float* __restrict__ nll, float* __restrict__ logz, float* __restrict__ hits,
              int N, int Hh, int C, int top) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ws = hs + kRows * h_pitch(Hh);
  float* ls = reinterpret_cast<float*>(ws + Hh * kWPitch);  // [32][33]

  const int k = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const uint16_t* w2k = w2 + static_cast<size_t>(k) * Hh * C;
  const uint16_t* b2k = b2 + static_cast<size_t>(k) * C;

  load_hidden(hs, hidden + static_cast<size_t>(k) * N * Hh, r0, N, Hh, tid);
  const int row = r0 + tid;  // threads 0..31 reduce one row each
  const bool row_ok = tid < kRows && row < N;
  const int t = row_ok ? targets[static_cast<size_t>(k) * N + row] : -1;
  float m = -INFINITY, l = 0.f, tl = -INFINITY;
  int count = 0;

  for (int pass = 0; pass < 2; ++pass) {
    for (int v0 = 0; v0 < C; v0 += kVt) {
      __syncthreads();  // every warp is done with the previous w2 and logits tiles
      load_w2_tile(ws, w2k, v0, C, Hh, tid);
      __syncthreads();
      float c[4];
      logits_piece(c, hs, ws, Hh, warp, g, t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (warp & 1) * 16 + g + (e >= 2 ? 8 : 0);
        const int cl = (warp >> 1) * 8 + t4 * 2 + (e & 1);
        const int col = v0 + cl;
        ls[r * (kVt + 1) + cl] = c[e] + (col < C ? bf16_float(b2k[col]) : 0.f);
      }
      __syncthreads();
      if (row_ok) {
        const int n = min(kVt, C - v0);
        const float* lr = ls + tid * (kVt + 1);
        if (pass == 0) {
          for (int cl = 0; cl < n; ++cl) {
            const float x = lr[cl];
            if (x > m) {
              l = l * expf(m - x) + 1.f;
              m = x;
            } else {
              l += expf(x - m);
            }
            if (v0 + cl == t) tl = x;
          }
        } else {
          for (int cl = 0; cl < n; ++cl) count += lr[cl] > tl ? 1 : 0;
        }
      }
    }
  }
  if (row_ok) {
    const size_t o = static_cast<size_t>(k) * N + row;
    const float z = m + logf(l);
    logz[o] = z;
    nll[o] = z - tl;
    hits[o] = count < top ? 1.f : 0.f;
  }
}

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

__global__ void __launch_bounds__(kThreads)
ce_dw2_kernel(const uint16_t* __restrict__ hidden, const uint16_t* __restrict__ w2,
              const uint16_t* __restrict__ b2, const int* __restrict__ targets,
              const float* __restrict__ logz, const float* __restrict__ gin,
              float* __restrict__ dw2, float* __restrict__ db2, int N, int Hh, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ws = hs + kRows * h_pitch(Hh);
  uint16_t* ds = ws + Hh * kWPitch;
  int* ts = reinterpret_cast<int*>(ds + kRows * kWPitch);
  float* zs = reinterpret_cast<float*>(ts + kRows);
  float* gs = zs + kRows;

  const int k = blockIdx.y;
  const int v0 = blockIdx.x * kVt;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t kn = static_cast<size_t>(k) * N;
  const uint16_t* b2k = b2 + static_cast<size_t>(k) * C;

  load_w2_tile(ws, w2 + static_cast<size_t>(k) * Hh * C, v0, C, Hh, tid);

  const int rows = Hh / 8;  // this warp's rows of dw2 [h0, h0 + rows)
  const int h0 = warp * rows;
  const int mtiles = rows / 16;  // <= 8
  float acc[8][kVt / 8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int nt = 0; nt < kVt / 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  float db = 0.f;  // threads 0..31: column v0 + tid

  for (int r0 = 0; r0 < N; r0 += kRows) {
    __syncthreads();  // the previous row block's hidden and dlogits are consumed
    load_hidden(hs, hidden + kn * Hh, r0, N, Hh, tid);
    load_row_stats(ts, zs, gs, targets + kn, logz + kn, gin + kn, r0, N, tid);
    __syncthreads();
    dlogits_tile(ds, hs, ws, b2k, ts, zs, gs, v0, C, Hh, warp, g, t4);
    __syncthreads();
    // dw2[h, 32] += hidden^T[h, 32 rows] . dlogits[32 rows, 32]
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t b[kVt / 8][2];
#pragma unroll
      for (int nt = 0; nt < kVt / 8; ++nt) load_b_kn(b[nt], ds, kWPitch, kk * 16, nt * 8, g, t4);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        if (mt < mtiles) {
          uint32_t a[4];
          load_a_t(a, hs, h_pitch(Hh), h0 + mt * 16, kk * 16, g, t4);
#pragma unroll
          for (int nt = 0; nt < kVt / 8; ++nt) mma_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
    if (tid < kVt) {
      for (int r = 0; r < kRows; ++r) db += bf16_float(ds[r * kWPitch + tid]);
    }
  }

  float* out = dw2 + static_cast<size_t>(k) * Hh * C;
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    if (mt < mtiles) {
      const int ha = h0 + mt * 16 + g;
      const int hb = ha + 8;
#pragma unroll
      for (int nt = 0; nt < kVt / 8; ++nt) {
        const int col = v0 + nt * 8 + t4 * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < C) {
            out[static_cast<size_t>(ha) * C + col + e] = acc[mt][nt][e];
            out[static_cast<size_t>(hb) * C + col + e] = acc[mt][nt][2 + e];
          }
        }
      }
    }
  }
  if (tid < kVt && v0 + tid < C) db2[static_cast<size_t>(k) * C + v0 + tid] = db;
}

bool valid_shape(int K, int N, int Hh, int C) {
  return K > 0 && K <= 65535 && N > 0 && C > 0 && Hh >= 128 && Hh <= kMaxHh && Hh % 128 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(); cudaErrorInvalidValue for shapes the kernels do not take.

extern "C" int ssr_fused_ce_fwd_bf16(const void* hidden, const void* w2, const void* b2,
                                     const void* targets, void* nll, void* logz,
                                     void* hits, int K, int N, int Hh, int C, int top,
                                     void* stream) {
  if (!valid_shape(K, N, Hh, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ce_fwd_kernel, fwd_smem(kMaxHh));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, K);
  ce_fwd_kernel<<<grid, kThreads, fwd_smem(Hh), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(hidden), static_cast<const uint16_t*>(w2),
      static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
      static_cast<float*>(nll), static_cast<float*>(logz), static_cast<float*>(hits), N,
      Hh, C, top);
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

extern "C" int ssr_fused_ce_bwd_dw2_bf16(const void* hidden, const void* w2, const void* b2,
                                         const void* targets, const void* logz,
                                         const void* g, void* dw2, void* db2, int K, int N,
                                         int Hh, int C, void* stream) {
  if (!valid_shape(K, N, Hh, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ce_dw2_kernel, tiles_smem(kMaxHh));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kVt - 1) / kVt, K);
  ce_dw2_kernel<<<grid, kThreads, tiles_smem(Hh), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(hidden), static_cast<const uint16_t*>(w2),
      static_cast<const uint16_t*>(b2), static_cast<const int*>(targets),
      static_cast<const float*>(logz), static_cast<const float*>(g),
      static_cast<float*>(dw2), static_cast<float*>(db2), N, Hh, C);
  return static_cast<int>(cudaGetLastError());
}
