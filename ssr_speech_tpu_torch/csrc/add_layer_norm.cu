// Bias + residual + LayerNorm of the e830M block's inference steps (K13), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX leaves the residual adds and the norm of its
// prefill and decode steps to XLA's fusions. In PyTorch the same chain was
// about 14 kernels a norm (the norm's 12, the bias and the residual add), 33
// norms a step. It computes, for each row of [R, D], what the plain version
// ops/add_layer_norm.py::plain_add_layer_norm computes:
//
//   mode norm:               h' = h
//   mode bias_then_residual: h' = bf16(h + bf16(y + bias))  (out projection)
//   mode residual_then_bias: h' = bf16(bf16(h + y) + bias)  (JAX's FFN order)
//   mean = sum(h') / D,  var = sum((h' - mean)^2) / D       fp32, two passes
//   hn   = bf16(((h' - mean) * rsqrt(var + eps)) * w + b)   w, b fp32
//
// Every add, product and rounding is the plain version's, in its order
// (`__fadd_rn` / `__fmul_rn`: no contraction into an fma), so h' is bit for
// bit the plain h'; only the order of the two sums differs, so hn is within
// one bf16 ulp of the plain hn, except where `* w + b` cancels to a value far
// below its terms (there the sums' last-bit difference is many ulps of it).
//
// What bounds it: at decode's 2-32 rows, latency. A row is 4 KB of h at
// D = 2048 and each element costs a handful of operations, so the bytes of
// the whole call take well under a microsecond at 3.35 TB/s; what is left is
// one round trip to memory and two block reductions. The design:
//
// - One block a row, 256 threads; a thread owns up to kMaxChunks chunks of
//   8 elements (one 16-byte load of each bf16 operand, two of each fp32
//   one), so every load of the block is issued before the first use and the
//   row stays in registers between the two passes.
// - Each sum: a warp butterfly, then the 8 warps' partials from shared
//   memory, added by every thread in warp order. No atomics: two runs agree
//   bit for bit.
// - The grid is the row count, so the prefill's B * S rows take the same
//   kernel; nothing is read back to the host, so a CUDA graph captures it.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 2;                 // 8-element chunks a thread
constexpr int kMaxD = kThreads * kMaxChunks * 8;

enum Mode { kNorm = 0, kBiasThenResidual = 1, kResidualThenBias = 2 };

struct AddLayerNormArgs {
  const __nv_bfloat16* h;
  const __nv_bfloat16* y;
  const __nv_bfloat16* bias;
  const float* w;
  const float* b;
  __nv_bfloat16* h_out;
  __nv_bfloat16* hn;
  int d;
  float inv_d;
  float eps;
};

__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// the block's sum of v: every thread gets it, the same bits in all
__device__ __forceinline__ float block_sum(float v, float* s_part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = s_part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t += s_part[w];
  return t;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_kernel(const AddLayerNormArgs a) {
  __shared__ float s_sum[kWarps], s_sq[kWarps];
  const long long row = static_cast<long long>(blockIdx.x) * a.d;
  const int n_chunks = a.d / 8;
  float x[kMaxChunks][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c >= n_chunks) continue;
    const long long at = row + c * 8;
    unpack8(__ldg(reinterpret_cast<const uint4*>(a.h + at)), x[i]);
    if (kMode != kNorm) {
      float y[8], bias[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(a.y + at)), y);
      unpack8(__ldg(reinterpret_cast<const uint4*>(a.bias + c * 8)), bias);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[i][j] = kMode == kBiasThenResidual
                      ? round_bf16(__fadd_rn(x[i][j], round_bf16(__fadd_rn(y[j], bias[j]))))
                      : round_bf16(__fadd_rn(round_bf16(__fadd_rn(x[i][j], y[j])), bias[j]));
      }
      *reinterpret_cast<uint4*>(a.h_out + at) = pack8(x[i]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, x[i][j]);
  }
  const float mean = __fmul_rn(block_sum(sum, s_sum), a.inv_d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (threadIdx.x + i * kThreads >= n_chunks) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dv = __fsub_rn(x[i][j], mean);
      sq = __fadd_rn(sq, __fmul_rn(dv, dv));
    }
  }
  const float var = __fmul_rn(block_sum(sq, s_sq), a.inv_d);
  const float r = rsqrtf(__fadd_rn(var, a.eps));
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c >= n_chunks) continue;
    float w[8], b[8], o[8];
    load8f(a.w + c * 8, w);
    load8f(a.b + c * 8, b);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x[i][j], mean), r), w[j]), b[j]);
    *reinterpret_cast<uint4*>(a.hn + row + c * 8) = pack8(o);
  }
}

}  // namespace

// Launches one call over `rows` rows of width d; returns the CUDA error (0 on
// success). `y`, `bias` and `h_out` are not read or written in mode 0.
extern "C" int ssr_add_layer_norm_bf16(const void* h, const void* y, const void* bias,
                                       const void* w, const void* b, void* h_out, void* hn,
                                       int rows, int d, int mode, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d % 8 != 0 || d > kMaxD || mode < kNorm ||
      mode > kResidualThenBias) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AddLayerNormArgs a;
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.h_out = static_cast<__nv_bfloat16*>(h_out);
  a.hn = static_cast<__nv_bfloat16*>(hn);
  a.d = d;
  a.inv_d = 1.0f / static_cast<float>(d);
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kNorm) {
    add_layer_norm_kernel<kNorm><<<rows, kThreads, 0, s>>>(a);
  } else if (mode == kBiasThenResidual) {
    add_layer_norm_kernel<kBiasThenResidual><<<rows, kThreads, 0, s>>>(a);
  } else {
    add_layer_norm_kernel<kResidualThenBias><<<rows, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
