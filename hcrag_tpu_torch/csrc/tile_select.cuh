// tile_select.cuh — the per-tile top-k selection that kernels B1
// (int8_tile_topk.cu), B4 and B5 (float_tile_topk.cu) share, and the
// sorted-list merges of B2 (packed_candidate_merge.cu) and of B5 / B7f on
// the tensor cores (`merge_pair`).
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

// The 64 keys a (element lane) and b (element lane + 32) of a warp, sorted
// descending across the warp by a bitonic network: afterwards a holds the
// lane-th largest and b the (lane + 32)-th.
template <typename Key>
__device__ __forceinline__ void sort64_desc(Key& a, Key& b, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: element lane against lane + 32
        const Key hi = a > b ? a : b, lo = a > b ? b : a;
        a = hi;
        b = lo;
        continue;
      }
      const Key pa = __shfl_xor_sync(FULL, a, stride);
      const Key pb = __shfl_xor_sync(FULL, b, stride);
      const bool lower = (lane & stride) == 0;  // the pair's lower element
      // Blocks with (index & size) == 0 sort descending, the others
      // ascending; the lower element of a descending pair keeps the larger.
      const bool keep_a = lower == ((lane & size) == 0);
      const bool keep_b = lower == (((lane + 32) & size) == 0);
      a = keep_a ? (a > pa ? a : pa) : (a > pa ? pa : a);
      b = keep_b ? (b > pb ? b : pb) : (b > pb ? pb : b);
    }
  }
}

// Merge a warp's 64 candidates (a at element lane, b at lane + 32) into
// the descending list L[0..k) in shared memory, whose empty slots hold
// `filler`, below every candidate key.  Only candidates above L[k - 1]
// count.  A few go in one at a time (insert_key); more are sorted
// (sort64_desc) into `scratch` (64 keys of shared memory) and merged by
// rank: each survivor's place in the union is its place in its own list
// plus the count of the other list's keys above it (a binary search), and
// the union's first k are written back.  Keys are unique within a list's
// tile (fillers aside), so ranks never collide.  Called by a whole warp.
template <typename Key>
__device__ __forceinline__ void merge_pair(Key* L, int k, Key a, Key b, Key filler,
                                           Key* scratch, int lane) {
  constexpr int SERIAL = 4;  // past this many survivors, sort and merge
  const Key thr = L[k - 1];
  const unsigned ma = __ballot_sync(FULL, a > thr);
  const unsigned mb = __ballot_sync(FULL, b > thr);
  const int m = __popc(ma) + __popc(mb);
  if (m == 0) return;
  if (m <= SERIAL) {
    unsigned x = ma;
    while (x) {
      const int src = __ffs(x) - 1;
      x &= x - 1;
      insert_key(L, k, __shfl_sync(FULL, a, src), lane);
    }
    x = mb;
    while (x) {
      const int src = __ffs(x) - 1;
      x &= x - 1;
      insert_key(L, k, __shfl_sync(FULL, b, src), lane);
    }
    return;
  }
  if (!(a > thr)) a = filler;
  if (!(b > thr)) b = filler;
  sort64_desc(a, b, lane);  // the m survivors first
  scratch[lane] = a;
  scratch[lane + 32] = b;
  __syncwarp();
  Key lv[4], cv[2];
  int lr[4], cr[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    lr[j] = k;  // not written
    if (i < k) {
      lv[j] = L[i];
      int lo = 0, hi = m;  // survivors above lv[j]
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (scratch[mid] > lv[j]) lo = mid + 1; else hi = mid;
      }
      lr[j] = i + lo;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = lane + 32 * j;
    cr[j] = k;
    if (t < m) {
      cv[j] = j ? b : a;
      int lo = 0, hi = k;  // list keys above cv[j]
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (L[mid] > cv[j]) lo = mid + 1; else hi = mid;
      }
      cr[j] = t + lo;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lr[j] < k) L[lr[j]] = lv[j];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (cr[j] < k) L[cr[j]] = cv[j];
  __syncwarp();
}

}  // namespace tile_select
