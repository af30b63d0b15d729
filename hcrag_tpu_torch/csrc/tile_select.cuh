// tile_select.cuh — the sorted-list merges that the per-tile top-k kernels
// share: B1, B3e, B7i, B5 and B7f on the tensor cores (tc_tile_topk.cuh),
// B4, and B5 / B7f over an f32 bank, on the CUDA cores (float_tile_topk.cu),
// and B2 (packed_candidate_merge.cu).
//
// A block keeps, for each of its queries, a list of the k best keys seen so
// far in shared memory, sorted descending.  Keys are unique within a tile
// (the row sits in the key's low bits), so a plain `>` orders them fully and
// ties never arise.  A kernel's epilogue filters its keys against the list's
// k-th entry and gathers the few survivors of a sub-tile (at most 64 a
// query); one warp then merges them into the list (`merge_pair`): one at a
// time when few, else sorted and merged by rank (~k ln(tile / k) survivors
// a tile in all).
//
// `Key` is int (B1, B7i, B5, B7f: the packed score | lane key) or long long
// (B4, B3e: the order-preserving score bits | ~row word; B2's value |
// position word).  The caller fills the list with a filler key below every
// real key before the first merge.

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
