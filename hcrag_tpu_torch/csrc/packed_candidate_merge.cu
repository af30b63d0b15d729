// packed_candidate_merge — kernel B2 of the port: the cross-tile merge of
// the per-tile candidates that kernel B1 writes.
//
// Replaces `_merge_vals_kernel` via `_packed_candidate_merge`
// (hcrag_tpu/ops/topk_pallas.py), which `_merge_tile_candidates` routes the
// merge to when the pool holds >= 4096 candidates and out_k <= 128.
//
// Contract, per query row of the pool v, i [b, tiles, k] (B1's tile-major
// output): the top out_k candidates ordered by the value quantized as
// bits(v + 2) & ~0x7FF (descending, as a signed int32), ties to the LOWEST
// slot-major position slot * tiles + tile (the order the JAX kernel merges
// in); the value decodes as float(qkey) - 2.0 and the index is gathered from
// i.  A quantized key <= 0 (the -1e30 fillers) decodes to (-1e30, -1).  The
// JAX kernel approximates this with a per-lane depth of 4 over 1024-column
// tiles; this kernel computes it exactly.
//
// What bounds it on an H100: it reads v once (b * tiles * k * 4 bytes,
// 160 MB at b = 8192, tiles * k = 4890), gathers out_k indices per query (a
// 32-byte sector each) and writes b * out_k * 8 bytes: ~0.05 ms at
// 3.35 TB/s.  Its few comparisons per candidate are far below the card's
// integer rate, so it is bound by bytes.
//
// Design: one block per query.  The block loads the pool into shared memory
// as unique 64-bit words (qkey << 32 | ~slot_major_position), so a plain
// signed max is the ordering above, and runs out_k rounds of a block-wide
// arg-max, each removing its winner.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(THREADS)
packed_candidate_merge_kernel(const float* __restrict__ v,
                              const int* __restrict__ idx,
                              float* __restrict__ out_v,
                              int* __restrict__ out_i, int tiles, int k,
                              int out_k) {
  extern __shared__ long long cand[];  // [tiles * k], tile-major
  __shared__ long long warp_best[WARPS];
  const int c = tiles * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* vr = v + row * c;
  const int* ir = idx + row * c;

  for (int p = tid; p < c; p += THREADS) {
    const unsigned key =
        (unsigned)(__float_as_int(__fadd_rn(vr[p], 2.0f)) & ~0x7FF);
    const int tile = p / k;
    const unsigned rank = (unsigned)((p - tile * k) * tiles + tile);
    cand[p] = (long long)(((unsigned long long)key << 32) |
                          (unsigned long long)(0xFFFFFFFFu - rank));
  }
  __syncthreads();

  for (int j = 0; j < out_k; ++j) {
    long long best = LLONG_MIN;
    for (int p = tid; p < c; p += THREADS) best = max64(best, cand[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = max64(best, __shfl_xor_sync(FULL, best, off));
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    best = warp_best[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) best = max64(best, warp_best[w]);
    const int qkey = (int)(best >> 32);
    const int rank = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFll));
    const int p = (rank % tiles) * k + rank / tiles;
    if (qkey > 0 && p % THREADS == tid) cand[p] = LLONG_MIN;
    if (tid == 0) {
      const size_t o = row * out_k + j;
      if (qkey > 0) {
        out_v[o] = __fsub_rn(__int_as_float(qkey), 2.0f);
        out_i[o] = ir[p];
      } else {
        out_v[o] = -1e30f;
        out_i[o] = -1;
      }
    }
    __syncthreads();  // the removal is seen and warp_best is free again
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers:
//   v [b, tiles, k] f32, idx [b, tiles, k] int32 (B1's candidates),
//   out_v [b, out_k] f32, out_i [b, out_k] int32.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int packed_candidate_merge(const void* v, const void* idx,
                                      void* out_v, void* out_i, int b,
                                      int tiles, int k, int out_k,
                                      void* stream) {
  if (b <= 0 || tiles <= 0 || k <= 0 || out_k < 1 || out_k > tiles * k)
    return (int)cudaErrorInvalidValue;
  const int c = tiles * k;
  const size_t smem = sizeof(long long) * (size_t)c;
  cudaError_t err = cudaFuncSetAttribute(
      packed_candidate_merge_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_candidate_merge_kernel<<<b, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)v, (const int*)idx, (float*)out_v, (int*)out_i, tiles, k,
      out_k);
  return (int)cudaGetLastError();
}
