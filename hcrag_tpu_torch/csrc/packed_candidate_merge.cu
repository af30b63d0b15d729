// packed_candidate_merge — kernel B2 of the port: the cross-tile merge of
// the per-tile candidates that kernels B1, B5 and B7 write.
//
// Replaces `_merge_vals_kernel` via `_packed_candidate_merge`
// (hcrag_tpu/ops/topk_pallas.py), which `_merge_tile_candidates` routes the
// merge to when the pool holds >= 4096 candidates and out_k <= 128.
//
// Contract, per query row of the pool v, i [b, tiles, k] (the tile-major
// output of the per-tile kernels): the top out_k candidates ordered by the
// value quantized as bits(v + 2) & ~0x7FF (descending, as a signed int32),
// ties to the LOWEST slot-major position slot * tiles + tile (the order the
// JAX kernel merges in); the value decodes as float(qkey) - 2.0 and the
// index is gathered from i.  A quantized key <= 0 (the -1e30 fillers)
// decodes to (-1e30, -1).  The JAX kernel approximates this with a per-lane
// depth of 4 over 1024-column tiles; this kernel computes it exactly, for a
// pool of any size, with out_k up to 128.
//
// What bounds it on an H100: it reads v once (b * tiles * k * 4 bytes,
// 160 MB at b = 8192, tiles * k = 4890), gathers out_k indices per query (a
// 32-byte sector each) and writes b * out_k * 8 bytes: ~0.05 ms at
// 3.35 TB/s.  Its few comparisons per candidate are far below the card's
// integer rate, so it is bound by bytes.
//
// Design: one pass over the pool and no final sort.  Each candidate becomes
// the unique 64-bit word qkey << 32 | ~position, so a plain signed `>`
// orders the pool fully under the contract.  A warp streams its share of a
// query's pool from device memory in the pool's own (tile-major, coalesced)
// order, 2 * UNROLL loads in flight per lane, and keeps the out_k best words
// seen so far as a sorted list in shared memory: for each run of 64, a
// ballot keeps the words above the list's last entry, and only those join
// the list (tile_select::merge_pair: one at a time when few, else by a
// bitonic sort of the run and a merge by rank), against the out_k
// block-wide arg-max rounds over the whole pool of the first version.  A
// query takes `wpq` warps (1, 2, 4 or 8; the wrapper picks enough to fill
// the card at small batches), each over every wpq-th run of 64 candidates;
// the block's 8 warps hold 8 / wpq queries, and the first warp of each
// query merges its group's other lists into its own behind a barrier of the
// group's warps, then decodes.  The list is already in output order.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tile_select.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = tile_select::MAX_K;  // 128
constexpr int UNROLL = 2;                    // runs of 64 loaded ahead per warp

__device__ __forceinline__ long long word_of(float v, int p, int tiles, int k) {
  const int qkey = __float_as_int(__fadd_rn(v, 2.0f)) & ~0x7FF;
  const int tile = p / k;
  const unsigned pos = (unsigned)((p - tile * k) * tiles + tile);  // slot-major
  return (long long)(((unsigned long long)(unsigned)qkey << 32) |
                     (unsigned long long)(0xFFFFFFFFu - pos));
}

__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ v, const int* __restrict__ idx,
             float* __restrict__ out_v, int* __restrict__ out_i, int b, int tiles,
             int k, int out_k, int wpq) {
  __shared__ long long lists[WARPS][MAX_OUT];
  __shared__ long long scratch[WARPS][64];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / wpq;       // the block's query slot
  const int w = warp - group * wpq;   // this warp's share of the query
  const long long row = (long long)blockIdx.x * (WARPS / wpq) + group;
  const bool live = row < b;          // uniform over the group
  const int c = tiles * k;
  long long* L = lists[warp];
  long long* S = scratch[warp];
  for (int j = lane; j < out_k; j += 32) L[j] = LLONG_MIN;  // below every word
  __syncwarp();

  if (live) {
    const float* vr = v + row * c;
    const int step = 64 * wpq;  // a warp's runs of 64 are `step` apart
    for (int p0 = 64 * w; p0 < c; p0 += UNROLL * step) {
      float x[UNROLL][2];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + u * step + 32 * h + lane;
          x[u][h] = p < c ? __ldg(vr + p) : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int p = p0 + u * step + lane;
        const long long a = p < c ? word_of(x[u][0], p, tiles, k) : LLONG_MIN;
        const long long b2 = p + 32 < c ? word_of(x[u][1], p + 32, tiles, k) : LLONG_MIN;
        tile_select::merge_pair(L, out_k, a, b2, LLONG_MIN, S, lane);
      }
    }
  }

  if (wpq > 1)  // the group's lists are complete
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * wpq) : "memory");
  if (w != 0 || !live) return;
  for (int o = 1; o < wpq; ++o) {
    const long long* M = lists[warp + o];  // sorted descending
    for (int j0 = 0; j0 < out_k && M[j0] > L[out_k - 1]; j0 += 64) {
      const long long a = j0 + lane < out_k ? M[j0 + lane] : LLONG_MIN;
      const long long b2 = j0 + 32 + lane < out_k ? M[j0 + 32 + lane] : LLONG_MIN;
      tile_select::merge_pair(L, out_k, a, b2, LLONG_MIN, S, lane);
    }
  }
  const int* ir = idx + row * c;
  for (int j = lane; j < out_k; j += 32) {
    const long long word = L[j];
    const int qkey = (int)(word >> 32);
    const unsigned pos = 0xFFFFFFFFu - (unsigned)(word & 0xFFFFFFFFll);
    const size_t o = row * out_k + j;
    if (qkey > 0) {
      out_v[o] = __fsub_rn(__int_as_float(qkey), 2.0f);
      out_i[o] = ir[(size_t)(pos % tiles) * k + pos / tiles];
    } else {
      out_v[o] = -1e30f;
      out_i[o] = -1;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers:
//   v [b, tiles, k] f32, idx [b, tiles, k] int32 (the per-tile candidates),
//   out_v [b, out_k] f32, out_i [b, out_k] int32; `wpq` warps per query
//   (1, 2, 4 or 8).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int packed_candidate_merge(const void* v, const void* idx,
                                      void* out_v, void* out_i, int b, int tiles,
                                      int k, int out_k, int wpq, void* stream) {
  if (b <= 0 || tiles <= 0 || k <= 0 || out_k < 1 || out_k > MAX_OUT ||
      (long long)tiles * k > INT_MAX / 2 || out_k > tiles * k ||
      (wpq != 1 && wpq != 2 && wpq != 4 && wpq != 8))
    return (int)cudaErrorInvalidValue;
  const int qpb = WARPS / wpq;
  const int blocks = (b + qpb - 1) / qpb;
  merge_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const int*)idx, (float*)out_v, (int*)out_i, b, tiles, k,
      out_k, wpq);
  return (int)cudaGetLastError();
}
