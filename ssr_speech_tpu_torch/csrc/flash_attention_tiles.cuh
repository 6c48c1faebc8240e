// What the three flash-attention kernels (forward, dq, dk/dv) share: the tile
// geometry, the masked-tile skip rule and small packing helpers.
//
// The mask is `key <= query && seg[query] == seg[key]`, walked in 64 x 64
// tiles. A (query tile, key tile) pair gets a flag:
//   kSkip    no pair in it can attend: above the diagonal, or the two tiles'
//            segment-id ranges [min, max] are disjoint (conservative for any
//            integer ids: overlapping ranges are visited even if no id is
//            shared);
//   kMasked  visited with the per-element mask: the diagonal tile (always
//            visited, so every row sees at least itself), mixed segments, or
//            a tile that hangs over the end of the sequence;
//   kDense   visited without a mask: below the diagonal, wholly inside the
//            sequence, one segment id on both sides.
// `ops/flash_attention.py::tile_visits` is the same rule in PyTorch.
//
// The forward and the dq kernel walk key tiles for a block of 64 queries the
// same way: `key_tile_flags` and `produce_kv_tiles` are that walk's two ends.

#pragma once

#include <limits.h>
#include <stdint.h>

#include "hopper_tma_wgmma.cuh"
#include "mma_fragments.cuh"

namespace ssr {
namespace flash {

using namespace ssr::sm90;

constexpr int kHeadDim = 128;
constexpr int kTile = 64;                           // rows of every tile
constexpr int kTileBytes = kTile * kHeadDim * 2;    // one [64 x 128] bf16 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSeq = 1 << 20;  // one flag byte a tile in shared memory

enum : unsigned char { kSkip = 0, kMasked = 1, kDense = 2 };

// 2^x on the special-function unit in one instruction (2 ulp; -inf gives 0):
// exp2f costs three more for a range the softmax never reaches.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// [min, max] of seg over rows [64 tile, 64 tile + 64) that lie inside the
// sequence, by one warp; an empty tile gives [INT_MAX, INT_MIN].
__device__ __forceinline__ void tile_seg_range(const int* segb, int tile, int S, int lane,
                                               int& mn, int& mx) {
  const int r = tile * kTile + lane;
  mn = INT_MAX;
  mx = INT_MIN;
  if (r < S) mn = mx = segb[r];
  if (r + 32 < S) {
    const int v = segb[r + 32];
    mn = min(mn, v);
    mx = max(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

// The flag of (query tile qt, key tile kt) from the two tiles' id ranges.
__device__ __forceinline__ unsigned char tile_flag(int qt, int kt, int S, int qmn, int qmx,
                                                   int kmn, int kmx) {
  if (kt > qt || kt * kTile >= S || qt * kTile >= S) return kSkip;
  if (kt == qt) return kMasked;
  if (kmx < qmn || kmn > qmx) return kSkip;
  const bool whole = (qt + 1) * kTile <= S;  // kt < qt: the key tile is whole
  return (whole && qmn == qmx && kmn == kmx) ? kDense : kMasked;
}

// The per-element mask of a kMasked tile.
__device__ __forceinline__ bool attends(int query, int key, int S, int seg_q, int seg_k) {
  return key <= query && query < S && seg_q == seg_k;
}

// flags[n] of query tile `qt` for its key tiles n = 0..qt, a warp a key tile;
// the block synchronises before anyone reads them.
__device__ __forceinline__ void key_tile_flags(unsigned char* flags, const int* segb, int qt,
                                               int S, int tid, int n_threads) {
  const int lane = tid & 31;
  int qmn, qmx;
  tile_seg_range(segb, qt, S, lane, qmn, qmx);
  for (int n = tid >> 5; n <= qt; n += n_threads / 32) {
    int kmn, kmx;
    tile_seg_range(segb, n, S, lane, kmn, kmx);
    if (lane == 0) flags[n] = tile_flag(qt, n, S, qmn, qmx, kmn, kmx);
  }
}

// K and V tiles of 64 keys from row n0 into a stage of the ring, by one thread.
__device__ __forceinline__ void start_kv_tile(uint32_t kv_s, uint32_t full_bar, int stage,
                                              const CUtensorMap* kmap, const CUtensorMap* vmap,
                                              int n0, int bh) {
  const uint32_t dst = kv_s + stage * 2 * kTileBytes;
  mbar_arrive_expect_tx(full_bar + 8 * stage, 2 * kTileBytes);
  tma_load_tile128(dst, kmap, full_bar + 8 * stage, n0, bh, kTile);
  tma_load_tile128(dst + kTileBytes, vmap, full_bar + 8 * stage, n0, bh, kTile);
}

// The producer warp's loop over the visited key tiles of query tile `qt`: K
// and V tiles by TMA into the ring at `kv_s` (stage: K tile, V tile), the
// tile's 64 segment ids into `seg_s` by the lanes. A stage's full barrier
// takes two arrivals (the TMA request with its byte count, the ids staged), its
// empty barrier one a consumer warp.
template <int kStages>
__device__ __forceinline__ void produce_kv_tiles(const unsigned char* flags, int qt,
                                                 const int* segb, int S, int bh, int* seg_s,
                                                 uint32_t kv_s, uint32_t full_bar,
                                                 uint32_t empty_bar, const CUtensorMap* kmap,
                                                 const CUtensorMap* vmap, int lane) {
  int it = 0;
  for (int n = 0; n <= qt; ++n) {
    if (flags[n] == kSkip) continue;
    const int stage = it % kStages;
    const uint32_t parity = ((it / kStages) & 1) ^ 1;  // the ring starts empty
    ++it;
    const int n0 = n * kTile;
    // While the ring fills, the stage is free: start the TMA loads before the
    // ids' round trip to global memory. Once it is full, fetch the ids while
    // waiting for the consumers to free the stage.
    const bool filling = it <= kStages;
    if (filling) {
      mbar_wait(empty_bar + 8 * stage, parity);
      if (lane == 0) start_kv_tile(kv_s, full_bar, stage, kmap, vmap, n0, bh);
    }
    const int id0 = n0 + lane < S ? segb[n0 + lane] : 0;
    const int id1 = n0 + 32 + lane < S ? segb[n0 + 32 + lane] : 0;
    if (!filling) {
      mbar_wait(empty_bar + 8 * stage, parity);
      if (lane == 0) start_kv_tile(kv_s, full_bar, stage, kmap, vmap, n0, bh);
    }
    seg_s[stage * kTile + lane] = id0;
    seg_s[stage * kTile + 32 + lane] = id1;
    __syncwarp();
    if (lane == 0) mbar_arrive(full_bar + 8 * stage);
  }
}

// A 64 x 64 accumulator tile as the A fragments of the next product's four
// 16-deep steps, rounded to bf16: two adjacent 8-column blocks a step.
__device__ __forceinline__ void pack_fragments(const float (&s)[32], uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A barrier among the 128 threads of one warpgroup (barrier 0 is the block's).
__device__ __forceinline__ void warpgroup_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// Writes a warpgroup's 64 x 128 accumulator tile as bf16 rows [r0, r0 + 64) of
// a [S x 128] head (rows past S dropped), rows g and g + 8 of each warp scaled
// by scale0 and scale1. The tile goes through `stage`, 16 KB of shared memory
// that no one reads any more once the whole warpgroup is here (an operand tile
// of its own), so that global memory gets 16-byte stores, two whole rows a
// warp, instead of 4-byte ones scattered over 8 rows. The 16-byte chunks of a
// row are permuted by its index mod 8, which keeps both sides off bank
// conflicts without a padded pitch.
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[64], float scale0,
                                                float scale1, unsigned char* stage,
                                                uint16_t* head, int r0, int S, int group,
                                                int tid_in_group) {
  const int lane = tid_in_group & 31;
  const int t4 = lane & 3;
  const int row0 = (tid_in_group >> 5) * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  warpgroup_sync(group);  // every warp is past its last product
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(stage + row0 * 256 + ((dt ^ (row0 & 7)) << 4) + t4 * 4) =
        pack_bf16(acc[4 * dt] * scale0, acc[4 * dt + 1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + row1 * 256 + ((dt ^ (row1 & 7)) << 4) + t4 * 4) =
        pack_bf16(acc[4 * dt + 2] * scale1, acc[4 * dt + 3] * scale1);
  }
  warpgroup_sync(group);
#pragma unroll
  for (int i = 0; i < kTile * 16 / 128; ++i) {
    const int c = i * 128 + tid_in_group;
    const int r = c >> 4;
    const int ch = c & 15;
    if (r0 + r < S) {
      *reinterpret_cast<uint4*>(head + static_cast<size_t>(r0 + r) * kHeadDim + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * 256 + ((ch ^ (r & 7)) << 4));
    }
  }
}

}  // namespace flash
}  // namespace ssr
