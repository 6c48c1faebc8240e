// Decode attention of the continuous server's paged step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX's paged step (`attend_layer` of
// ssr_speech_tpu/models/transformer.py::transformer_decode_step_paged) leaves
// this attention to XLA einsums. It computes, for one layer, what the plain
// version ops/decode_attention.py::plain_paged_attention computes:
//
//   qs = bf16(q * scale)                 (scale = bf16(1 / sqrt(128)))
//   s  = [ qs.Kp[j]  for prompt keys j < tp that key_banned leaves open
//        | qs.Kg[j]  for generated columns j < min(gen_len[r], rl)
//        | qs.k      the current token ]   fp32 sums of the bf16 products
//   p  = bf16(exp(s - max s) / sum exp(s - max s))   one fp32 softmax
//   out[r, h] = bf16( sum_j p[j] * V[j] )  accumulated in fp32
//
// where the plain version adds -1e9 to the scores of the dead keys, whose
// exponentials are then exact zeros in fp32: leaving them out changes
// nothing. The one difference: the three partial outputs (prompt, generated,
// current) are summed in fp32 and rounded once, where the plain version
// rounds each to bf16 and adds them in bf16.
//
// Layouts (elements): q, k, v [B, H, Dh] with row pitches q_ld, k_ld, v_ld
// and head pitch Dh (the head split of the step's packed QKV product); the
// prompt cache pk, pv [B, H, p_cap, Dh] and the generated cache gk, gv
// [B, H, g_cap, Dh] of one layer, contiguous; key_banned uint8 [B, ban_ld]
// (1 = dead); gen_len int64 [B]; out [B, H * Dh]. Dh is 128.
//
// What bounds it: bytes. A (row, head) does 4 operations for every 4 bytes of
// K and V it reads, far below the card's balance point, so the least time is
// the live keys' K/V bytes over the memory rate (3.35 TB/s on an H100 SXM).
// The plain version read the whole windows widened to fp32 (about 10 bytes an
// element of traffic over mostly dead keys). The design:
//
// - A cluster of kCluster blocks owns one (row, head): grid (kCluster, H, B).
//   The keys [prompt | generated] are cut into chunks of kChunk; block `rank`
//   takes chunks rank, rank + kCluster, ..., so each block of a cluster gets
//   a like share of the live keys whatever the row's layout. Chunks at and
//   past tp + min(gen_len, rl) are not visited at all.
// - A key row is 256 bytes: 16 lanes read it as one 16-byte load each, so a
//   warp reads two keys and a block eight an instruction; kUnroll passes of
//   loads are in flight before their products. A dead key is not loaded:
//   its flag comes from the block's copy of the row's key_banned bytes.
// - Pass 1 keeps the block's scores in shared memory. The blocks of the
//   cluster exchange their maxima, then their sums of exponentials, through
//   distributed shared memory; each turns its scores into probabilities
//   rounded to bf16 (the two-pass order keeps the rounding of normalised
//   probabilities that an online softmax would lose).
// - Pass 2 reads V only where the probability is not zero. Each block sums
//   its eight key slots in a fixed order; block 0 adds the cluster's partial
//   outputs in rank order, then the current token's, and stores bf16. No
//   atomics: two runs agree bit for bit.
// - The grid is fixed by the shapes; lengths are read on the device, so one
//   CUDA graph capture serves every step of a stage window.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ssr_speech_tpu_torch/ops/cuda_build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDh = 128;
constexpr int kCluster = 4;                     // blocks of one (row, head)
constexpr int kThreads = 128;                   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = kDh / 8;           // 16 lanes x 8 bf16 = one key row
constexpr int kSlots = kThreads / kLanesPerKey; // keys a block reads an instruction
constexpr int kUnroll = 4;                      // loads in flight a lane
constexpr int kChunk = kSlots * kUnroll;        // keys of one chunk

struct DecodeAttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long q_ld, k_ld, v_ld;
  const __nv_bfloat16* pk;
  const __nv_bfloat16* pv;
  const __nv_bfloat16* gk;
  const __nv_bfloat16* gv;
  const uint8_t* banned;
  long long ban_ld;
  const long long* gen_len;
  __nv_bfloat16* out;
  int p_cap, g_cap, tp, rl;
  float scale;
};

__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// a lane's 8 products of q and a key row, fp32 sums in order
__device__ __forceinline__ float dot_key(const float (&qf)[8], const uint4 raw) {
  float kf[8];
  unpack8(raw, kf);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s = fmaf(qf[i], kf[i], s);
  return s;
}

// the 16 lanes of a key summed by a butterfly: only the lane with part 0
// keeps its result (the lanes' sums associate differently)
__device__ __forceinline__ float sum_key_lanes(float s) {
#pragma unroll
  for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 8)
paged_decode_attn_kernel(const DecodeAttnArgs a) {
  extern __shared__ float s_p[];        // this block's scores, then probabilities
  __shared__ float s_slot[kSlots][kDh]; // pass 2's sums by key slot
  __shared__ float s_out[kDh];          // the block's partial output (cluster-read)
  __shared__ float s_warp[kWarps];
  __shared__ float s_max, s_sum;        // the block's statistics (cluster-read)
  __shared__ float s_cur[2];            // the current key's score, then its probability

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, r = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = tid / kLanesPerKey, part = tid % kLanesPerKey;
  const int tp = a.tp;
  // the row's key_banned bytes, past the scores (s_p[0, cap) floats)
  const int n_all_chunks = (tp + a.rl + kChunk - 1) / kChunk;
  const int cap = (n_all_chunks + kCluster - 1) / kCluster * kChunk;
  uint8_t* s_ban = reinterpret_cast<uint8_t*>(s_p + cap);
  const uint8_t* ban_row = a.banned + static_cast<long long>(r) * a.ban_ld;
  for (int j = tid; j < tp; j += kThreads) s_ban[j] = ban_row[j];

  long long gl = a.gen_len[r];
  gl = gl < 0 ? 0 : (gl > a.rl ? a.rl : gl);
  const int n_end = tp + static_cast<int>(gl);  // keys at and past it are dead
  const int n_chunks = (n_end + kChunk - 1) / kChunk;
  const long long rh = static_cast<long long>(r) * H + h;
  const __nv_bfloat16* pk = a.pk + rh * a.p_cap * kDh + part * 8;
  const __nv_bfloat16* pv = a.pv + rh * a.p_cap * kDh + part * 8;
  const __nv_bfloat16* gk = a.gk + rh * a.g_cap * kDh + part * 8;
  const __nv_bfloat16* gv = a.gv + rh * a.g_cap * kDh + part * 8;

  // q scaled in bf16, as the plain version's q * scale
  float qf[8];
  {
    float raw[8];
    unpack8(load16(a.q + r * a.q_ld + h * kDh + part * 8), raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[i] = __bfloat162float(__float2bfloat16(raw[i] * a.scale));
  }
  __syncthreads();  // s_ban

  // pass 1: scores of this block's chunks
  float my_max = -INFINITY;
  int local = 0;
  for (int c = rank; c < n_chunks; c += kCluster, ++local) {
    uint4 kr[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c * kChunk + u * kSlots + slot;
      live[u] = j < tp ? s_ban[j] == 0 : j < n_end;
      if (live[u]) kr[u] = load16(j < tp ? pk + j * kDh : gk + (j - tp) * kDh);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float s = sum_key_lanes(live[u] ? dot_key(qf, kr[u]) : 0.f);
      if (part == 0) {
        const float val = live[u] ? s : -INFINITY;
        s_p[local * kChunk + u * kSlots + slot] = val;
        my_max = fmaxf(my_max, val);
      }
    }
  }
  const int n_local = local * kChunk;
  // the current token's key: block 0's first warp (both halves alike)
  if (rank == 0 && warp == 0) {
    const float s = sum_key_lanes(dot_key(qf, load16(a.k + r * a.k_ld + h * kDh + part * 8)));
    if (lane == 0) {
      s_cur[0] = s;
      my_max = fmaxf(my_max, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_max = fmaxf(my_max, __shfl_xor_sync(0xffffffffu, my_max, off));
  if (lane == 0) s_warp[warp] = my_max;
  __syncthreads();
  if (tid == 0) {
    float m = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_warp[w]);
    s_max = m;
  }
  cluster.sync();
  float row_max = -INFINITY;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) row_max = fmaxf(row_max, *cluster.map_shared_rank(&s_max, q));

  // exponentials and the block's sum (fixed order); the dead keys give 0
  float my_sum = 0.f;
  for (int i = tid; i < n_local; i += kThreads) {
    const float e = expf(s_p[i] - row_max);
    s_p[i] = e;
    my_sum += e;
  }
  if (rank == 0 && tid == 0) {
    const float e = expf(s_cur[0] - row_max);
    s_cur[1] = e;
    my_sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) my_sum += __shfl_down_sync(0xffffffffu, my_sum, off);
  if (lane == 0) s_warp[warp] = my_sum;  // the maxima were read before cluster.sync
  __syncthreads();
  if (tid == 0) {
    float t = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += s_warp[w];
    s_sum = t;
  }
  cluster.sync();
  float row_sum = 0.f;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) row_sum += *cluster.map_shared_rank(&s_sum, q);

  // probabilities, normalised then rounded to bf16
  for (int i = tid; i < n_local; i += kThreads)
    s_p[i] = __bfloat162float(__float2bfloat16(s_p[i] / row_sum));
  __syncthreads();

  // pass 2: P.V over the keys whose probability is not zero
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  local = 0;
  for (int c = rank; c < n_chunks; c += kCluster, ++local) {
    uint4 vr[kUnroll];
    float pr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c * kChunk + u * kSlots + slot;
      pr[u] = s_p[local * kChunk + u * kSlots + slot];
      if (pr[u] != 0.f) vr[u] = load16(j < tp ? pv + j * kDh : gv + (j - tp) * kDh);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (pr[u] != 0.f) {
        float vf[8];
        unpack8(vr[u], vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(pr[u], vf[i], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s_slot[slot][part * 8 + i] = acc[i];
  __syncthreads();
  {
    float o = s_slot[0][tid];
#pragma unroll
    for (int k = 1; k < kSlots; ++k) o += s_slot[k][tid];
    s_out[tid] = o;
  }
  cluster.sync();
  if (rank == 0) {
    float o = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) o += cluster.map_shared_rank(s_out, q)[tid];
    const float p_cur = __bfloat162float(__float2bfloat16(s_cur[1] / row_sum));
    o = fmaf(p_cur, __bfloat162float(a.v[r * a.v_ld + h * kDh + tid]), o);
    a.out[rh * kDh + tid] = __float2bfloat16(o);
  }
  cluster.sync();  // no block leaves while block 0 may still read its s_out
}

static_assert(kThreads == kDh, "the epilogue gives each thread one output column");

}  // namespace

// Launches the kernel for one layer; returns the CUDA error (0 on success).
// A prompt and window too long for a block's shared memory (its share of the
// scores, then the row's key_banned bytes) are refused by the attribute call.
extern "C" int ssr_paged_decode_attention_bf16(
    const void* q, const void* k, const void* v, long long q_ld, long long k_ld,
    long long v_ld, const void* pk, const void* pv, int p_cap, const void* gk,
    const void* gv, int g_cap, const void* banned, long long ban_ld,
    const void* gen_len, void* out, int B, int H, int tp, int rl, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || tp < 0 || rl < 0 || tp > p_cap ||
      rl > g_cap || tp > ban_ld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_all_chunks = (tp + rl + kChunk - 1) / kChunk;
  const long long smem = static_cast<long long>((n_all_chunks + kCluster - 1) / kCluster) *
                             kChunk * 4 + (tp + 15) / 16 * 16;
  // the opt-in above 48 KB is per device: set on every call (it is cheap)
  cudaError_t err = cudaFuncSetAttribute(paged_decode_attn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  DecodeAttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_ld = q_ld;
  a.k_ld = k_ld;
  a.v_ld = v_ld;
  a.pk = static_cast<const __nv_bfloat16*>(pk);
  a.pv = static_cast<const __nv_bfloat16*>(pv);
  a.gk = static_cast<const __nv_bfloat16*>(gk);
  a.gv = static_cast<const __nv_bfloat16*>(gv);
  a.banned = static_cast<const uint8_t*>(banned);
  a.ban_ld = ban_ld;
  a.gen_len = static_cast<const long long*>(gen_len);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.p_cap = p_cap;
  a.g_cap = g_cap;
  a.tp = tp;
  a.rl = rl;
  a.scale = scale;
  const dim3 grid(kCluster, H, B);
  paged_decode_attn_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
