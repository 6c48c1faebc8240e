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
// contiguous, seg is int32 [B, S]; any S is accepted (the ragged tail is masked
// here, nothing is padded). A row always sees its own diagonal.
//
// Design (simple first): one block of 4 warps per (query tile of 64 rows, head,
// batch row); each warp owns 16 query rows and keeps its Q fragments, its
// running max/sum and its 16x128 fp32 output tile in registers. The block walks
// the key/value tiles (64 keys) up to the causal limit; each tile is staged in
// shared memory with plain 16-byte loads, and both products (Q.K^T and P.V)
// run on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32 out). P is
// rounded to bf16 for the second product, as the plain version rounds the
// normalised probabilities.
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

#include "mma_fragments.cuh"

namespace {

using ssr::ld32;
using ssr::mma_16816;
using ssr::pack_bf16;

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;
// shared-memory row pitch in bf16 elements: +8 (16 bytes) moves consecutive
// rows 4 banks apart, so the fragment loads below are conflict-free
constexpr int kPitch = kHeadDim + 8;
constexpr size_t kSmemBytes =
    2 * kBlockN * kPitch * sizeof(uint16_t) + kBlockN * sizeof(int);

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int* __restrict__ seg,
                 uint16_t* __restrict__ out, float* __restrict__ lse, int H,
                 int S, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + kBlockN * kPitch;
  int* segs = reinterpret_cast<int*>(vs + kBlockN * kPitch);

  // the last query tiles carry the most keys: launch them first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within the warp's 8-row half
  const int t4 = lane & 3;   // column pair within a fragment

  const size_t head = (static_cast<size_t>(b) * H + h) * S * kHeadDim;
  const uint16_t* qh = q + head;
  const uint16_t* kh = k + head;
  const uint16_t* vh = v + head;
  uint16_t* oh = out + head;
  const int* segb = seg + static_cast<size_t>(b) * S;
  float* lseh = lse == nullptr ? nullptr : lse + (static_cast<size_t>(b) * H + h) * S;

  const int m0 = m_block * kBlockM;
  const int row0 = m0 + warp * 16 + g;  // this thread's two rows
  const int row1 = row0 + 8;
  const bool in0 = row0 < S;
  const bool in1 = row1 < S;
  const int seg0 = in0 ? segb[row0] : 0;
  const int seg1 = in1 ? segb[row1] : 0;

  // Q as mma A fragments, one per 16-wide slice of the head dimension
  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = in0 ? ld32(qh + static_cast<size_t>(row0) * kHeadDim + c) : 0u;
    qf[kk][1] = in1 ? ld32(qh + static_cast<size_t>(row1) * kHeadDim + c) : 0u;
    qf[kk][2] = in0 ? ld32(qh + static_cast<size_t>(row0) * kHeadDim + c + 8) : 0u;
    qf[kk][3] = in1 ? ld32(qh + static_cast<size_t>(row1) * kHeadDim + c + 8) : 0u;
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 domain)
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  const int kv_end = min(S, m0 + kBlockM);  // causal limit of the tile
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockN * (kHeadDim / 8); i += kThreads) {
      const int r = i / (kHeadDim / 8);
      const int c = (i % (kHeadDim / 8)) * 8;
      const int key = n0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) {
        kv = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(key) * kHeadDim + c);
        vv = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(key) * kHeadDim + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kPitch + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kPitch + c) = vv;
    }
    if (tid < kBlockN) segs[tid] = (n0 + tid < S) ? segb[n0 + tid] : 0;
    __syncthreads();

    // scores for 16 rows x 64 keys: s[nt] is the 16x8 tile of keys nt*8..
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint16_t* kp = ks + (nt * 8 + g) * kPitch + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        mma_16816(s[nt], qf[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
      }
    }

    // mask, scale into the log2 domain, row max over the 4 lanes of a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = nt * 8 + t4 * 2 + e;
        const int j = n0 + jl;
        const bool key_ok = j < S;
        const int sj = segs[jl];
        const float x0 = (key_ok && j <= row0 && sj == seg0) ? s[nt][e] * scale_log2 : -INFINITY;
        const float x1 = (key_ok && j <= row1 && sj == seg1) ? s[nt][2 + e] * scale_log2 : -INFINITY;
        s[nt][e] = x0;
        s[nt][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float new0 = fmaxf(m_run[0], mx0);
    const float new1 = fmaxf(m_run[1], mx1);
    // a row with no visible key yet keeps max -inf: subtract 0 instead, so
    // exp2(-inf - 0) = 0 rather than NaN
    const float base0 = new0 == -INFINITY ? 0.f : new0;
    const float base1 = new1 == -INFINITY ? 0.f : new1;
    const float alpha0 = exp2f(m_run[0] - base0);
    const float alpha1 = exp2f(m_run[1] - base1);
    m_run[0] = new0;
    m_run[1] = new1;
    l_run[0] *= alpha0;
    l_run[1] *= alpha1;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base0);
      s[nt][1] = exp2f(s[nt][1] - base0);
      s[nt][2] = exp2f(s[nt][2] - base1);
      s[nt][3] = exp2f(s[nt][3] - base1);
      l_run[0] += s[nt][0] + s[nt][1];
      l_run[1] += s[nt][2] + s[nt][3];
    }

    // acc += P.V: the score accumulators of two adjacent key tiles are
    // exactly the A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vp = vs + (kk * 16 + t4 * 2) * kPitch + g;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        const uint16_t* p = vp + dt * 8;
        const uint32_t b0 = static_cast<uint32_t>(p[0]) |
                            (static_cast<uint32_t>(p[kPitch]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(p[8 * kPitch]) |
                            (static_cast<uint32_t>(p[9 * kPitch]) << 16);
        mma_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (lseh != nullptr && t4 == 0) {
    // natural-log log-sum-exp of the scaled scores: m and l are in the log2
    // domain of scores * sm_scale
    constexpr float kLn2 = 0.6931471805599453f;
    if (in0) lseh[row0] = (m_run[0] + log2f(l0)) * kLn2;
    if (in1) lseh[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (in0) {
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row0) * kHeadDim + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row1) * kHeadDim + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): a
// refused launch (bad shape, too much shared memory) is reported here, not at
// the next synchronise. Returns cudaErrorInvalidValue for shapes the kernel
// does not take. `lse` (fp32 [B, H, S], the per-row log-sum-exp the backward
// needs) may be null: the serving path does not keep it.
extern "C" int ssr_flash_attention_fwd_bf16(const void* q, const void* k,
                                            const void* v, const void* seg,
                                            void* out, void* lse, int B, int H,
                                            int S, int head_dim, float sm_scale,
                                            void* stream) {
  if (head_dim != kHeadDim || B <= 0 || H <= 0 || S <= 0 || H > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(seg),
      static_cast<uint16_t*>(out), static_cast<float*>(lse), H, S, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
