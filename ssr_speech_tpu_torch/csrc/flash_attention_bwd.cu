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
// Inputs bf16 [B, H, S, 128] contiguous, seg int32 [B, S], L fp32 [B, H, S];
// any S (the ragged tail is masked, nothing is padded). Every row, of any
// segment, is defined: segment-0 rows attend segment-0 keys causally.
//
// Design (FlashAttention-2, simple first): two kernels and no float atomics,
// so the gradients are bit-reproducible.
//  * dq kernel: one block of 4 warps per (64-query tile, head, batch row);
//    each warp keeps its 16 rows of Q and dO as mma A fragments and its
//    16x128 fp32 dQ in registers, computes D for its rows (written out for the
//    second kernel), and walks the key tiles up to the diagonal.
//  * dk/dv kernel: one block per 64-key tile; each warp owns 16 keys and keeps
//    their 16x128 fp32 dK and dV in registers. It walks the query tiles from
//    the diagonal down, recomputes P^T and dP^T with the keys as the M side
//    of the products, and accumulates P^T.dO and dS^T.Q.
// All five products per tile run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 out); P and dS are rounded to bf16 only as the A
// operand of the dV/dK/dQ products. Bound by the tensor-core rate at training
// shapes (about 2.5x the forward's flops); what it leaves on the table is
// wgmma, TMA double-buffering and skipping fully masked tiles.
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

constexpr int kHeadDim = 128;
constexpr int kBlock = 64;  // queries per dq block, keys per dk/dv block, tile size
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = kHeadDim + 8;  // smem row pitch (bf16), conflict-free fragments
constexpr int kTile = kBlock * kPitch;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kDqSmem = 2 * kTile * sizeof(uint16_t) + kBlock * sizeof(int);
constexpr size_t kDkvSmem = 4 * kTile * sizeof(uint16_t) + 3 * kBlock * sizeof(float);

// rows [r0, r0 + 64) of a [S, 128] head into a smem tile; zero past S
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, int r0,
                                          int S, int tid) {
  for (int i = tid; i < kBlock * (kHeadDim / 8); i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = (i % (kHeadDim / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * kHeadDim + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kPitch + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld_row32(const uint16_t* base, int row, bool in, int c) {
  return in ? ld32(base + static_cast<size_t>(row) * kHeadDim + c) : 0u;
}

__device__ __forceinline__ float dot_bf16x2(uint32_t a, uint32_t b) {
  return bf16_float(static_cast<uint16_t>(a & 0xffffu)) * bf16_float(static_cast<uint16_t>(b & 0xffffu)) +
         bf16_float(static_cast<uint16_t>(a >> 16)) * bf16_float(static_cast<uint16_t>(b >> 16));
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const int* __restrict__ seg,
                    const uint16_t* __restrict__ out, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    uint16_t* __restrict__ dq, int H, int S, float scale_log2,
                    float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + kTile;
  int* segs = reinterpret_cast<int*>(vs + kTile);

  const int m_block = gridDim.x - 1 - blockIdx.x;  // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t head = (static_cast<size_t>(b) * H + h) * S;
  const uint16_t* qh = q + head * kHeadDim;
  const uint16_t* kh = k + head * kHeadDim;
  const uint16_t* vh = v + head * kHeadDim;
  const uint16_t* oh = out + head * kHeadDim;
  const uint16_t* doh = dout + head * kHeadDim;
  uint16_t* dqh = dq + head * kHeadDim;
  const int* segb = seg + static_cast<size_t>(b) * S;

  const int m0 = m_block * kBlock;
  const int row0 = m0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < S;
  const bool in1 = row1 < S;
  const int seg0 = in0 ? segb[row0] : 0;
  const int seg1 = in1 ? segb[row1] : 0;
  const float lse0 = in0 ? lse[head + row0] * kLog2e : 0.f;
  const float lse1 = in1 ? lse[head + row1] * kLog2e : 0.f;

  // Q and dO as A fragments; D = rowsum(dO * O) over the same columns
  uint32_t qf[kHeadDim / 16][4];
  uint32_t df[kHeadDim / 16][4];
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = ld_row32(qh, row0, in0, c);
    qf[kk][1] = ld_row32(qh, row1, in1, c);
    qf[kk][2] = ld_row32(qh, row0, in0, c + 8);
    qf[kk][3] = ld_row32(qh, row1, in1, c + 8);
    df[kk][0] = ld_row32(doh, row0, in0, c);
    df[kk][1] = ld_row32(doh, row1, in1, c);
    df[kk][2] = ld_row32(doh, row0, in0, c + 8);
    df[kk][3] = ld_row32(doh, row1, in1, c + 8);
    d0 += dot_bf16x2(df[kk][0], ld_row32(oh, row0, in0, c));
    d1 += dot_bf16x2(df[kk][1], ld_row32(oh, row1, in1, c));
    d0 += dot_bf16x2(df[kk][2], ld_row32(oh, row0, in0, c + 8));
    d1 += dot_bf16x2(df[kk][3], ld_row32(oh, row1, in1, c + 8));
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if (t4 == 0) {
    if (in0) dsum[head + row0] = d0;
    if (in1) dsum[head + row1] = d1;
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int kv_end = min(S, m0 + kBlock);  // causal limit of the tile
  for (int n0 = 0; n0 < kv_end; n0 += kBlock) {
    __syncthreads();
    load_tile(ks, kh, n0, S, tid);
    load_tile(vs, vh, n0, S, tid);
    if (tid < kBlock) segs[tid] = (n0 + tid < S) ? segb[n0 + tid] : 0;
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T for 16 rows x 64 keys
    float s[kBlock / 8][4];
    float dp[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        uint32_t bk[2], bv[2];
        load_b_nk(bk, ks, kPitch, kk * 16, nt * 8, g, t4);
        load_b_nk(bv, vs, kPitch, kk * 16, nt * 8, g, t4);
        mma_16816(s[nt], qf[kk], bk[0], bk[1]);
        mma_16816(dp[nt], df[kk], bv[0], bv[1]);
      }
    }
    // dS = P * (dP - D), masked entries 0; kept in s
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = nt * 8 + t4 * 2 + (e & 1);
        const int j = n0 + jl;
        const bool top = e < 2;
        const int row = top ? row0 : row1;
        const bool ok = (top ? in0 : in1) && j < S && j <= row && segs[jl] == (top ? seg0 : seg1);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - (top ? lse0 : lse1)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (top ? d0 : d1));
      }
    }
    // dQ += dS.K: K's rows are the 16-deep k steps
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        uint32_t bk[2];
        load_b_kn(bk, ks, kPitch, kk * 16, dt * 8, g, t4);
        mma_16816(acc[dt], a, bk[0], bk[1]);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (in0) {
      *reinterpret_cast<uint32_t*>(dqh + static_cast<size_t>(row0) * kHeadDim + c) =
          pack_bf16(acc[dt][0] * sm_scale, acc[dt][1] * sm_scale);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(dqh + static_cast<size_t>(row1) * kHeadDim + c) =
          pack_bf16(acc[dt][2] * sm_scale, acc[dt][3] * sm_scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, const int* __restrict__ seg,
                      const uint16_t* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, uint16_t* __restrict__ dk,
                      uint16_t* __restrict__ dv, int H, int S, float scale_log2,
                      float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* kS = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vS = kS + kTile;
  uint16_t* qS = vS + kTile;
  uint16_t* doS = qS + kTile;
  float* lseS = reinterpret_cast<float*>(doS + kTile);
  float* dS = lseS + kBlock;
  int* segS = reinterpret_cast<int*>(dS + kBlock);

  const int n0 = blockIdx.x * kBlock;  // the first key tiles walk the most queries
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t head = (static_cast<size_t>(b) * H + h) * S;
  const uint16_t* qh = q + head * kHeadDim;
  const uint16_t* doh = dout + head * kHeadDim;
  const int* segb = seg + static_cast<size_t>(b) * S;

  const int key0 = n0 + warp * 16 + g;  // this thread's two keys
  const int key1 = key0 + 8;
  const bool in0 = key0 < S;
  const bool in1 = key1 < S;
  const int segk0 = in0 ? segb[key0] : 0;
  const int segk1 = in1 ? segb[key1] : 0;

  load_tile(kS, k + head * kHeadDim, n0, S, tid);
  load_tile(vS, v + head * kHeadDim, n0, S, tid);

  float dka[kHeadDim / 8][4];
  float dva[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  for (int m0 = n0; m0 < S; m0 += kBlock) {  // queries from the diagonal down
    __syncthreads();
    load_tile(qS, qh, m0, S, tid);
    load_tile(doS, doh, m0, S, tid);
    if (tid < kBlock) {
      const bool in = m0 + tid < S;
      lseS[tid] = in ? lse[head + m0 + tid] * kLog2e : 0.f;
      dS[tid] = in ? dsum[head + m0 + tid] : 0.f;
      segS[tid] = in ? segb[m0 + tid] : 0;
    }
    __syncthreads();

    // S^T = K.Q^T and dP^T = V.dO^T for 16 keys x 64 queries
    float s[kBlock / 8][4];
    float dp[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, kS, kPitch, warp * 16, kk * 16, g, t4);
      load_a(av, vS, kPitch, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        uint32_t bq[2], bd[2];
        load_b_nk(bq, qS, kPitch, kk * 16, nt * 8, g, t4);
        load_b_nk(bd, doS, kPitch, kk * 16, nt * 8, g, t4);
        mma_16816(s[nt], ak, bq[0], bq[1]);
        mma_16816(dp[nt], av, bd[0], bd[1]);
      }
    }
    // P^T into s, dS^T = P^T * (dP^T - D) into dp
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = nt * 8 + t4 * 2 + (e & 1);
        const int i = m0 + il;
        const bool top = e < 2;
        const int key = top ? key0 : key1;
        const bool ok = (top ? in0 : in1) && i < S && key <= i && segS[il] == (top ? segk0 : segk1);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lseS[il]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dS[il]);
      }
    }
    // dV += P^T.dO and dK += dS^T.Q: the queries are the 16-deep k steps
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        uint32_t bd[2], bq[2];
        load_b_kn(bd, doS, kPitch, kk * 16, dt * 8, g, t4);
        load_b_kn(bq, qS, kPitch, kk * 16, dt * 8, g, t4);
        mma_16816(dva[dt], ap, bd[0], bd[1]);
        mma_16816(dka[dt], ads, bq[0], bq[1]);
      }
    }
  }

  uint16_t* dkh = dk + head * kHeadDim;
  uint16_t* dvh = dv + head * kHeadDim;
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (in0) {
      const size_t o = static_cast<size_t>(key0) * kHeadDim + c;
      *reinterpret_cast<uint32_t*>(dkh + o) = pack_bf16(dka[dt][0] * sm_scale, dka[dt][1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvh + o) = pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (in1) {
      const size_t o = static_cast<size_t>(key1) * kHeadDim + c;
      *reinterpret_cast<uint32_t*>(dkh + o) = pack_bf16(dka[dt][2] * sm_scale, dka[dt][3] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvh + o) = pack_bf16(dva[dt][2], dva[dt][3]);
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
  if (head_dim != kHeadDim || B <= 0 || H <= 0 || S <= 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB is per device: set it on every call (it is cheap)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(seg),
      static_cast<const uint16_t*>(out), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dsum),
      static_cast<uint16_t*>(dq), H, S, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<grid, kThreads, kDkvSmem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(seg),
      static_cast<const uint16_t*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), H, S, scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
