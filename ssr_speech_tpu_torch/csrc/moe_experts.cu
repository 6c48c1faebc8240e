// K11: the routed experts of a MoE decode step, for Hopper (sm_90a).
//
// Replaces no TPU kernel (the JAX package has no MoE block). It computes,
// for one MoE layer of the MLA + MoE block, what the plain version
// ops/moe_experts.py::plain_moe_experts computes:
//
//   for each (row n, choice i) with e = idx[n, i] and row n live:
//     gu[n, i, j] = bf16(x[n] . Wgu[e, j])    j < 2F   (gate rows, then up)
//     hmid[n, i, j] = bf16(silu(g) * u)   g = gu[n, i, j], u = gu[n, i, F + j],
//                                         silu in fp32
//     y[n, i, d] = w[n, i] * bf16(hmid[n, i] . Wd[e, d])
//   and y[n, i, :] = 0 for a row that is not live
//
// with fp32 sums of the bf16 products; the caller adds y over the choices in
// fp32 (ops/moe_experts.py). Layouts (elements): x [N, D] bf16, idx int64
// [N, k], w fp32 [N, k], live uint8 [N] (null: every row), Wgu [E, 2F, D]
// and Wd [E, D, F] bf16 (one output's weights a contiguous row), gu bf16
// [N * k, 2F], hmid bf16 [N * k, F], y fp32 [N * k, D].
//
// What bounds it: bytes. A decode step routes N * k of its rows' choices over
// E experts, a few tokens an expert, so each weight element meets a few
// tokens: the least time is the touched experts' weights over the memory
// rate. The design:
//
// - Two product kernels, gate/up then down, each a resident grid whose
//   warps walk the (expert, tile of 16 output rows) items round-robin;
//   between them an elementwise kernel makes hmid of the gate and up
//   products (gate and up rows are separate items, so that a layer's
//   weights split into items small enough to share out evenly).
//   Every block first sorts the live (row, choice) slots by expert in
//   shared memory (a counting sort of N * k integers), so an item of an
//   expert that no live slot chose is skipped with no global read: an
//   untouched expert's weights are not read at all (a parked lane of the
//   server, or every row of a step past a chunk's end, reads none), and no
//   item waits on a global read of the routing.
// - An item is a small matrix product on the tensor cores (mma.sync
//   m16n8k16, bf16 in, fp32 accumulators): its 16 weight rows (the A
//   operand) streamed from memory once as 16-byte loads straight into the
//   fragments, against all of the expert's slots at once (the B operand:
//   their input rows, x or hmid, read through L2, once an item), in NT
//   n-tiles of 8. NT is chosen at the launch from N: an expert takes at
//   most one slot a row, so 8 NT >= N keeps every expert's slots in one
//   pass, one stream of its weights (NT 4 to 32 rows, 8 to 64, 16 past
//   that; only past 128 rows can an expert's slots need a second pass).
//   The k order inside a 16-wide step is permuted alike in A and B, so
//   that each lane's elements of a row are contiguous: the same sum.
// - Each (slot, output) is written by one lane: no atomics on the outputs,
//   and two runs agree bit for bit.
// - Block 0 of the first kernel adds each expert's live slot count, and 1
//   if it has any, to counts [2, E] (the server's device-side routing
//   counters; null: none).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 8192;              // N * k a call
constexpr int kMaxExperts = 256;
constexpr int kTileRows = 16;                // output rows an item (the mma's m)
constexpr int kKBlock = 32;                  // k a step of the weight stream

struct MoeArgs {
  const __nv_bfloat16* x;
  const long long* idx;
  const float* w;
  const uint8_t* live;
  const __nv_bfloat16* gu;
  const __nv_bfloat16* down;
  __nv_bfloat16* gu_out;
  __nv_bfloat16* hmid;
  float* y;
  int* counts;
  int nk, k, E, D, F;
};

struct SlotsByExpert {
  int cnt[kMaxExperts];
  int off[kMaxExperts];
  int cur[kMaxExperts];
  int slots[kMaxSlots];
};

__device__ __forceinline__ bool slot_live(const MoeArgs& a, int slot) {
  return a.live == nullptr || a.live[slot / a.k] != 0;
}

// the weights: read once, so streamed (evict first)
__device__ __forceinline__ uint4 stream16(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two k-steps of 16 from 16-byte pieces: rows g and g + 8 of A (lo, hi), the
// slot's row of B; each lane's 8 elements at k0 + 8 t are its four of each
// step (elements 0-3 the first step, 4-7 the second)
__device__ __forceinline__ void mma_k32(float (&c)[4], const uint4 lo, const uint4 hi,
                                        const uint4 b) {
  mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_bf16(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the live (row, choice) slots grouped by expert (a counting sort; the order
// within an expert is the atomics', which no output depends on)
__device__ void sort_slots(const MoeArgs& a, SlotsByExpert& s) {
  for (int e = threadIdx.x; e < a.E; e += kThreads) {
    s.cnt[e] = 0;
    s.cur[e] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.nk; i += kThreads) {
    if (slot_live(a, i)) atomicAdd(&s.cnt[a.idx[i]], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0;
    for (int e = 0; e < a.E; ++e) {
      s.off[e] = o;
      o += s.cnt[e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.nk; i += kThreads) {
    if (!slot_live(a, i)) continue;
    const int e = static_cast<int>(a.idx[i]);
    s.slots[s.off[e] + atomicAdd(&s.cur[e], 1)] = i;
  }
  __syncthreads();
}

// One item: out[r, s] = sum_k A[r, k] B[s, k] for the 16 rows of A at `a0`
// (rows g and g + 8 a lane, pitch `lda`) over the slots `slots[0, n)`, in
// passes of 8 NT (one pass wherever n <= 8 NT), B's row of slot s at
// `b + boff(s)`, length K. `emit(slot, row, v)` takes each (slot, row)
// result.
template <int NT, typename BOff, typename Emit>
__device__ __forceinline__ void item_product(const __nv_bfloat16* a0, long long lda, int K,
                                             const int* slots, int n,
                                             const __nv_bfloat16* b, BOff boff, Emit emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* ar0 = a0 + g * lda + 8 * t4;
  const __nv_bfloat16* ar1 = ar0 + 8 * lda;
  for (int base = 0; base < n; base += 8 * NT) {
    int br[NT];  // element offsets of the lane's B rows from b
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int i = base + q * 8 + g;
      br[q] = boff(slots[i < n ? i : n - 1]) + 8 * t4;
    }
    const int nq = min(NT, (n - base + 7) / 8);
    float acc[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += kKBlock) {
      const uint4 lo = stream16(ar0 + k0), hi = stream16(ar1 + k0);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        if (q < nq) {
          mma_k32(acc[q], lo, hi, __ldg(reinterpret_cast<const uint4*>(b + br[q] + k0)));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = base + q * 8 + 2 * t4 + (c & 1);
        if (q < nq && i < n) emit(slots[i], g + 8 * (c >> 1), acc[q][c]);
      }
    }
  }
}

// two resident blocks an SM where the accumulators fit the registers of two
constexpr int blocks_per_sm(int nt) { return nt <= 8 ? 2 : 1; }

template <int NT>
__global__ void __launch_bounds__(kThreads, (NT <= 8 ? 2 : 1)) moe_gate_up_kernel(const MoeArgs a) {
  __shared__ SlotsByExpert s;
  sort_slots(a, s);
  if (blockIdx.x == 0 && a.counts != nullptr) {
    for (int e = threadIdx.x; e < a.E; e += kThreads) {
      a.counts[e] += s.cnt[e];
      a.counts[a.E + e] += s.cnt[e] > 0;
    }
  }
  const int tiles = 2 * a.F / kTileRows;
  const long long items = static_cast<long long>(a.E) * tiles;
  const int stride = gridDim.x * kWarps;
  for (long long item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items; item += stride) {
    const int e = static_cast<int>(item / tiles), j0 = static_cast<int>(item % tiles) * kTileRows;
    const int n = s.cnt[e];
    if (n == 0) continue;
    item_product<NT>(
        a.gu + (static_cast<long long>(e) * 2 * a.F + j0) * a.D, a.D, a.D,
        s.slots + s.off[e], n, a.x, [&](int slot) { return (slot / a.k) * a.D; },
        [&](int slot, int row, float v) {
          a.gu_out[static_cast<long long>(slot) * 2 * a.F + j0 + row] = __float2bfloat16(v);
        });
  }
}

// hmid = bf16(silu(gate) * up) of the rounded products, silu in fp32 (live
// slots only)
__global__ void __launch_bounds__(kThreads) moe_act_kernel(const MoeArgs a) {
  const long long n = static_cast<long long>(a.nk) * a.F;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long slot = i / a.F, j = i % a.F;
    if (!slot_live(a, static_cast<int>(slot))) continue;
    const float g = __bfloat162float(a.gu_out[slot * 2 * a.F + j]);
    const float u = __bfloat162float(a.gu_out[slot * 2 * a.F + a.F + j]);
    a.hmid[i] = __float2bfloat16(g / (1.f + expf(-g)) * u);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, (NT <= 8 ? 2 : 1)) moe_down_kernel(const MoeArgs a) {
  __shared__ SlotsByExpert s;
  sort_slots(a, s);
  if (a.live != nullptr) {  // a dead row's slots: zeros
    const long long n = static_cast<long long>(a.nk) * a.D;
    for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * kThreads) {
      if (!slot_live(a, static_cast<int>(i / a.D))) a.y[i] = 0.f;
    }
  }
  const int tiles = a.D / kTileRows;
  const long long items = static_cast<long long>(a.E) * tiles;
  const int stride = gridDim.x * kWarps;
  for (long long item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items; item += stride) {
    const int e = static_cast<int>(item / tiles), j0 = static_cast<int>(item % tiles) * kTileRows;
    const int n = s.cnt[e];
    if (n == 0) continue;
    item_product<NT>(
        a.down + (static_cast<long long>(e) * a.D + j0) * a.F, a.F, a.F,
        s.slots + s.off[e], n,
        // hmid is written by the previous kernel: read after it, in order
        a.hmid, [&](int slot) { return slot * a.F; },
        [&](int slot, int row, float v) {
          a.y[static_cast<long long>(slot) * a.D + j0 + row] = a.w[slot] * round_bf16(v);
        });
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int NT>
int launch(const MoeArgs& a, cudaStream_t s) {
  const int blocks = blocks_per_sm(NT) * sm_count();
  moe_gate_up_kernel<NT><<<blocks, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_act_kernel<<<(a.nk * a.F + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_down_kernel<NT><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the three kernels of one MoE layer; returns the CUDA error (0 on
// success). Shapes outside the kernels' tiles are refused.
extern "C" int ssr_moe_experts_bf16(const void* x, const void* idx, const void* w,
                                    const void* live, const void* gu, const void* down,
                                    void* gu_out, void* hmid, void* y, void* counts, int N,
                                    int k, int E, int D, int F, void* stream) {
  if (N <= 0 || k <= 0 || E <= 0 || E > kMaxExperts || N * k > kMaxSlots ||
      D % kKBlock != 0 || F % kKBlock != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MoeArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.idx = static_cast<const long long*>(idx);
  a.w = static_cast<const float*>(w);
  a.live = static_cast<const uint8_t*>(live);
  a.gu = static_cast<const __nv_bfloat16*>(gu);
  a.down = static_cast<const __nv_bfloat16*>(down);
  a.gu_out = static_cast<__nv_bfloat16*>(gu_out);
  a.hmid = static_cast<__nv_bfloat16*>(hmid);
  a.y = static_cast<float*>(y);
  a.counts = static_cast<int*>(counts);
  a.nk = N * k;
  a.k = k;
  a.E = E;
  a.D = D;
  a.F = F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // an expert takes at most one slot a row: 8 NT >= N slots is one pass
  if (N <= 32) return launch<4>(a, s);
  if (N <= 64) return launch<8>(a, s);
  return launch<16>(a, s);
}
