// K12: the latent (MLA) decode attention of the continuous server's paged
// step, for Hopper (sm_90a).
//
// Replaces no TPU kernel (the JAX package has no MLA block). For one layer
// and each row r it computes, in the absorbed form, what the plain version
// ops/mla_attention.py::plain_paged_mla_attention computes:
//
//   keys  = [ prompt latents j < tp that key_banned leaves open
//           | generated latents j < min(gen_len[r], rl)
//           | the row's current latent ]              each [c | k_pe], 576 wide
//   s[h, j] = (q[h] . keys[j]) * scale                fp32 sums of bf16 products
//   out[h]  = sum_j softmax_j(s[h])[j] * keys[j][:512] (the latent c)
//
// for the 16 heads of q [B, 16, 576] (q_nope absorbed into the latent | q_pe,
// unscaled). The plain version rounds the normalised probabilities to bf16;
// here each block keeps a running maximum and rounds exp(s - max) to bf16 for
// the products, and the division by the sum comes last, in fp32: the two
// differ by bf16 rounding of the probabilities.
//
// Layouts (elements): q [B, 16, 576], cur [B, 576], the prompt latents pk
// [B, p_cap, 576] and the generated gk [B, g_cap, 576] of one layer, all
// bf16 and contiguous; key_banned uint8 [B, ban_ld] (1 = dead); gen_len int64
// [B]; out bf16 [B, 16, 512].
//
// What bounds it: bytes. Every head of a row reads the same latents, so the
// least time is the live latents' bytes over the memory rate; the products
// (16 heads x 1,088 a key) run on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulators), the 16 heads being the 16 rows of an mma. The
// design:
//
// - A cluster of kSplit blocks owns one row: grid (kSplit, B). The keys are
//   cut into tiles of kTile; block `rank` takes tiles rank, rank + kSplit, ...
//   Tiles at and past the row's last live key are not visited.
// - A tile's latents arrive by cp.async into shared memory (rows padded so
//   that the mma fragments load without bank conflicts); a dead key is not
//   read: its row is zero-filled.
// - Scores: each warp multiplies the block's q (in shared memory) by 16 keys.
//   The block takes the tile's maximum, rescales its running sum and its
//   accumulators, and rounds exp(s - max) to bf16 in shared memory.
// - P.V: each warp owns 128 of the 512 output columns, 16 n-tiles of fp32
//   accumulators in registers, and reads the latents of the tile again from
//   shared memory as the B operand.
// - The cluster's blocks then exchange (max, sum, partial output) through
//   distributed shared memory; each block finishes 64 of the 512 columns of
//   every head. No atomics: two runs agree bit for bit.
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

constexpr int kH = 16;                 // heads: the m of the mma
constexpr int kLat = 512;              // the latent c (the output width)
constexpr int kDq = 576;               // [c | k_pe]
constexpr int kTile = 64;              // keys a tile
constexpr int kThreads = 128;          // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 8;              // blocks of a row (one cluster)
constexpr int kLd = kDq + 8;           // padded latent row in shared memory (bf16)
constexpr int kPLd = kTile + 8;        // padded probability row (bf16)
constexpr int kSLd = kTile + 4;        // padded score row (fp32)
constexpr int kVecRow = kDq / 8;       // 16-byte vectors a latent
constexpr int kColsWarp = kLat / kWarps;   // output columns a warp
constexpr int kNT = kColsWarp / 8;         // n-tiles a warp
constexpr int kColsBlock = kLat / kSplit;  // output columns a block finishes

constexpr size_t kQBytes = sizeof(__nv_bfloat16) * kH * kLd;
constexpr size_t kKBytes = sizeof(__nv_bfloat16) * kTile * kLd;
constexpr size_t kSBytes = sizeof(float) * kH * kSLd;
constexpr size_t kPBytes = sizeof(__nv_bfloat16) * kH * kPLd;
constexpr size_t kStatBytes = sizeof(float) * 3 * kH;
constexpr size_t kFixedBytes = kQBytes + kKBytes + kSBytes + kPBytes + kStatBytes;

static_assert(kKBytes >= sizeof(float) * kH * kLat, "the partial output reuses the key tile");
static_assert(kThreads == kH * 8, "the softmax gives each head eight threads");

struct MlaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* cur;
  const __nv_bfloat16* pk;
  const __nv_bfloat16* gk;
  const uint8_t* banned;
  long long ban_ld;
  const long long* gen_len;
  __nv_bfloat16* out;
  int p_cap, g_cap, tp, rl;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack2(const __nv_bfloat16 lo, const __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 2)
mla_decode_attn_kernel(const MlaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes);
  float* s_s = reinterpret_cast<float*>(smem + kQBytes + kKBytes);
  __nv_bfloat16* s_p = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + kKBytes + kSBytes);
  float* s_m = reinterpret_cast<float*>(smem + kQBytes + kKBytes + kSBytes + kPBytes);
  float* s_l = s_m + kH;
  float* s_alpha = s_l + kH;
  uint8_t* s_ban = smem + kFixedBytes;
  float* s_o = reinterpret_cast<float*>(s_k);  // the partial output, after the last tile

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tp = a.tp;

  const uint8_t* ban_row = a.banned + static_cast<long long>(r) * a.ban_ld;
  for (int j = tid; j < tp; j += kThreads) s_ban[j] = ban_row[j];
  const __nv_bfloat16* qrow = a.q + static_cast<long long>(r) * kH * kDq;
  for (int v = tid; v < kH * kVecRow; v += kThreads) {
    const int h = v / kVecRow, part = v % kVecRow;
    cp_async16(s_q + h * kLd + part * 8, qrow + h * kDq + part * 8, 16);
  }
  if (tid < kH) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  long long gl = a.gen_len[r];
  gl = gl < 0 ? 0 : (gl > a.rl ? a.rl : gl);
  const int n_gen = static_cast<int>(gl);
  const int n_end = tp + n_gen + 1;  // the last key is the row's current latent
  const int n_tiles = (n_end + kTile - 1) / kTile;
  const __nv_bfloat16* prow = a.pk + static_cast<long long>(r) * a.p_cap * kDq;
  const __nv_bfloat16* grow = a.gk + static_cast<long long>(r) * a.g_cap * kDq;
  const __nv_bfloat16* crow = a.cur + static_cast<long long>(r) * kDq;
  cp_async_wait_all();
  __syncthreads();  // s_ban, s_q, the statistics

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = rank; tile < n_tiles; tile += kSplit) {
    const int base = tile * kTile;
    // the tile's latents, dead keys zero-filled
    for (int v = tid; v < kTile * kVecRow; v += kThreads) {
      const int key = v / kVecRow, part = v % kVecRow;
      const int j = base + key;
      const bool live = j < tp ? s_ban[j] == 0 : j < n_end;
      const __nv_bfloat16* src =
          j < tp ? prow + static_cast<long long>(j) * kDq
                 : (j < tp + n_gen ? grow + static_cast<long long>(j - tp) * kDq : crow);
      cp_async16(s_k + key * kLd + part * 8, live ? src + part * 8 : crow, live ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: warp `warp` takes keys [16 warp, 16 warp + 16) of the tile
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const __nv_bfloat16* krow0 = s_k + (warp * 16 + g) * kLd + 2 * t4;
    const __nv_bfloat16* krow1 = krow0 + 8 * kLd;
#pragma unroll 4
    for (int k0 = 0; k0 < kDq; k0 += 16) {
      const unsigned a0 = lds32(s_q + g * kLd + k0 + 2 * t4);
      const unsigned a1 = lds32(s_q + (g + 8) * kLd + k0 + 2 * t4);
      const unsigned a2 = lds32(s_q + g * kLd + k0 + 8 + 2 * t4);
      const unsigned a3 = lds32(s_q + (g + 8) * kLd + k0 + 8 + 2 * t4);
      mma_bf16(sc[0], a0, a1, a2, a3, lds32(krow0 + k0), lds32(krow0 + k0 + 8));
      mma_bf16(sc[1], a0, a1, a2, a3, lds32(krow1 + k0), lds32(krow1 + k0 + 8));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = warp * 16 + nt * 8 + 2 * t4 + (c & 1);
        const int h = g + 8 * (c >> 1);
        const int j = base + key;
        const bool live = j < tp ? s_ban[j] == 0 : j < n_end;
        s_s[h * kSLd + key] = live ? sc[nt][c] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // the tile's maximum, the running statistics and the rounded exponentials
    {
      const int h = tid >> 3, sub = tid & 7;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, s_s[h * kSLd + sub * 8 + c]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[h];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float s = s_s[h * kSLd + sub * 8 + c];
        const __nv_bfloat16 pb = __float2bfloat16(s == -INFINITY ? 0.f : expf(s - m_new));
        s_p[h * kPLd + sub * 8 + c] = pb;
        ps += __bfloat162float(pb);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (sub == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        s_alpha[h] = alpha;
        s_l[h] = s_l[h] * alpha + ps;
        s_m[h] = m_new;
      }
    }
    __syncthreads();

    // P.V over the tile: warp `warp` owns columns [128 warp, 128 warp + 128)
    const float al0 = s_alpha[g], al1 = s_alpha[g + 8];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      const unsigned a0 = lds32(s_p + g * kPLd + kk + 2 * t4);
      const unsigned a1 = lds32(s_p + (g + 8) * kPLd + kk + 2 * t4);
      const unsigned a2 = lds32(s_p + g * kPLd + kk + 8 + 2 * t4);
      const unsigned a3 = lds32(s_p + (g + 8) * kPLd + kk + 8 + 2 * t4);
      const __nv_bfloat16* v0 = s_k + (kk + 2 * t4) * kLd + warp * kColsWarp + g;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const __nv_bfloat16* v = v0 + n * 8;
        const unsigned b0 = pack2(v[0], v[kLd]);
        const unsigned b1 = pack2(v[8 * kLd], v[9 * kLd]);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites s_k, s_s and s_p
  }

  // the block's partial output (unnormalised) into shared memory
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = warp * kColsWarp + n * 8 + 2 * t4;
    s_o[g * kLat + col] = acc[n][0];
    s_o[g * kLat + col + 1] = acc[n][1];
    s_o[(g + 8) * kLat + col] = acc[n][2];
    s_o[(g + 8) * kLat + col + 1] = acc[n][3];
  }
  cluster.sync();

  // the cluster's partials combined: this block finishes kColsBlock columns
  // of every head. Every remote read is issued before any is used (the
  // statistics, then the partial outputs as 16-byte vectors): one round of
  // distributed-shared-memory latency, not one a rank.
  {
    static_assert(kColsBlock == 64, "a thread finishes 8 columns: two float4");
    const int h = tid >> 3, sub = tid & 7;
    const int col0 = rank * kColsBlock + sub * 8;
    float mq[kSplit], lq[kSplit];
    float4 oq[kSplit][2];
#pragma unroll
    for (int q = 0; q < kSplit; ++q) {
      mq[q] = cluster.map_shared_rank(s_m, q)[h];
      lq[q] = cluster.map_shared_rank(s_l, q)[h];
      const float4* src =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(s_o, q) + h * kLat + col0);
      oq[q][0] = src[0];
      oq[q][1] = src[1];
    }
    float m_all = -INFINITY;
#pragma unroll
    for (int q = 0; q < kSplit; ++q) m_all = fmaxf(m_all, mq[q]);
    float den = 0.f, num[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kSplit; ++q) {
      const float wq = mq[q] == -INFINITY ? 0.f : expf(mq[q] - m_all);
      den = fmaf(wq, lq[q], den);
      num[0] = fmaf(wq, oq[q][0].x, num[0]);
      num[1] = fmaf(wq, oq[q][0].y, num[1]);
      num[2] = fmaf(wq, oq[q][0].z, num[2]);
      num[3] = fmaf(wq, oq[q][0].w, num[3]);
      num[4] = fmaf(wq, oq[q][1].x, num[4]);
      num[5] = fmaf(wq, oq[q][1].y, num[5]);
      num[6] = fmaf(wq, oq[q][1].z, num[6]);
      num[7] = fmaf(wq, oq[q][1].w, num[7]);
    }
    __nv_bfloat162 packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) packed[i] = __floats2bfloat162_rn(num[2 * i] / den, num[2 * i + 1] / den);
    *reinterpret_cast<uint4*>(a.out + (static_cast<long long>(r) * kH + h) * kLat + col0) =
        *reinterpret_cast<const uint4*>(packed);
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

}  // namespace

// Launches the kernel for one layer; returns the CUDA error (0 on success).
extern "C" int ssr_mla_decode_attention_bf16(const void* q, const void* cur, const void* pk,
                                             int p_cap, const void* gk, int g_cap,
                                             const void* banned, long long ban_ld,
                                             const void* gen_len, void* out, int B, int tp,
                                             int rl, float scale, void* stream) {
  if (B <= 0 || B > 65535 || tp < 0 || rl < 0 || tp > p_cap || rl > g_cap || tp > ban_ld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = kFixedBytes + static_cast<size_t>((tp + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(mla_decode_attn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  MlaArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.cur = static_cast<const __nv_bfloat16*>(cur);
  a.pk = static_cast<const __nv_bfloat16*>(pk);
  a.gk = static_cast<const __nv_bfloat16*>(gk);
  a.banned = static_cast<const uint8_t*>(banned);
  a.ban_ld = ban_ld;
  a.gen_len = static_cast<const long long*>(gen_len);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.p_cap = p_cap;
  a.g_cap = g_cap;
  a.tp = tp;
  a.rl = rl;
  a.scale = scale;
  mla_decode_attn_kernel<<<dim3(kSplit, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
