// tile_select.cuh — the per-tile top-k selection that kernels B1
// (int8_tile_topk.cu), B4 and B5 (float_tile_topk.cu) share.
//
// A block keeps, for each of its queries, a list of the k best keys seen so
// far in shared memory, sorted descending.  Keys are unique within a tile
// (the row sits in the key's low bits), so a plain `>` orders them fully and
// ties never arise.  After each staged sub-tile of 64 rows, one warp merges a
// query's 64 new keys into its list: each lane holds two keys, a ballot keeps
// those above the current k-th best, and the few survivors are inserted one
// at a time (~k ln(tile / k) inserts per tile in all).
//
// `Key` is int (B1 and B5: the packed score | lane key) or long long (B4:
// the order-preserving score bits | ~row word).  The caller fills the list
// with a filler key below every real key before the first merge.

#pragma once

#include <cuda_runtime.h>

namespace tile_select {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_K = 128;  // 4 list slots per lane

// Insert key c into the descending list L[0..k) held in shared memory, if it
// beats the last entry.  Called by a whole warp with the same c; lane l
// updates slots l, l + 32, l + 64, l + 96.
template <typename Key>
__device__ __forceinline__ void insert_key(Key* L, int k, Key c, int lane) {
  if (c <= L[k - 1]) return;  // every lane reads the same word
  Key nv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    if (i < k) {
      const Key old = L[i];
      nv[j] = old > c ? old : ((i == 0 || L[i - 1] > c) ? c : L[i - 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    if (i < k) L[i] = nv[j];
  }
  __syncwarp();
}

// Merge the 64 keys row[0..64) into the list L[0..k).  Called by a whole
// warp.
template <typename Key>
__device__ __forceinline__ void merge_64(const Key* row, Key* L, int k,
                                         int lane) {
  const Key a0 = row[lane];
  const Key a1 = row[lane + 32];
  const Key thr = L[k - 1];
  unsigned m0 = __ballot_sync(FULL, a0 > thr);
  unsigned m1 = __ballot_sync(FULL, a1 > thr);
  while (m0) {
    const int src = __ffs(m0) - 1;
    m0 &= m0 - 1;
    insert_key(L, k, __shfl_sync(FULL, a0, src), lane);
  }
  while (m1) {
    const int src = __ffs(m1) - 1;
    m1 &= m1 - 1;
    insert_key(L, k, __shfl_sync(FULL, a1, src), lane);
  }
}

}  // namespace tile_select
