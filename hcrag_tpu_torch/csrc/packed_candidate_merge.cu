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
// tiles; this kernel computes it exactly, for a pool of any size.
//
// What bounds it on an H100: it reads v once (b * tiles * k * 4 bytes,
// 160 MB at b = 8192, tiles * k = 4890), gathers out_k indices per query (a
// 32-byte sector each) and writes b * out_k * 8 bytes: ~0.05 ms at
// 3.35 TB/s.  Its few comparisons per candidate are far below the card's
// integer rate, so it is bound by bytes.
//
// Design: the pool is cut into chunks of whole tiles, `chunk_tiles` each,
// whose 4-byte keys fit one block's shared memory (58,096 keys: 10M rows at
// k = 10 give one chunk of 4,883 tiles x 10).  One block per (query, chunk)
// loads the chunk's quantized keys in the chunk's own slot-major order and
// runs out_k rounds of a block-wide arg-max over the unique 64-bit words
// qkey << 32 | ~position, each removing its winner.  Inside a chunk of
// consecutive tiles the local slot-major order is the global one, so each
// chunk's winners are its top out_k under the contract, and the global top
// out_k is among them.  With one chunk the block decodes its winners into
// the outputs; with more, it writes them as words with their global
// position, and a second pass, one block per query, runs the same rounds
// over the chunks' words and decodes.
//
// A removed key is INT_MIN and a removed word LLONG_MIN, below every
// filler's (a value of -2 + 2 gives +0.0, so no candidate's key is INT_MIN).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_SMEM = 232448;        // what one block may use on sm_90
constexpr int DEFAULT_SMEM = 47 * 1024;  // dynamic bytes that need no opt-in

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ long long word_of(int qkey, unsigned pos) {
  return (long long)(((unsigned long long)(unsigned)qkey << 32) |
                     (unsigned long long)(0xFFFFFFFFu - pos));
}

// The block-wide max of every thread's `best`; ends with a barrier, so the
// caller may change shared memory after it only behind another barrier.
__device__ __forceinline__ long long block_max(long long best, long long* warp_best) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max64(best, __shfl_xor_sync(FULL, best, off));
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  best = warp_best[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) best = max64(best, warp_best[w]);
  return best;
}

__device__ __forceinline__ void decode(int qkey, unsigned rank, const int* ir,
                                       int tiles, int k, float* ov, int* oi) {
  if (qkey > 0) {
    *ov = __fsub_rn(__int_as_float(qkey), 2.0f);
    *oi = ir[(size_t)(rank % tiles) * k + rank / tiles];
  } else {
    *ov = -1e30f;
    *oi = -1;
  }
}

// Pass 1: block (row, chunk) selects the chunk's top out_k.
template <bool FINAL>
__global__ void __launch_bounds__(THREADS)
merge_chunk_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   long long* __restrict__ words, int tiles, int k, int out_k,
                   int chunk_tiles) {
  extern __shared__ int keys[];  // [nt * k], the chunk's slot-major order
  __shared__ long long warp_best[WARPS];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int t0 = chunk * chunk_tiles;
  const int nt = min(chunk_tiles, tiles - t0);
  const int c = nt * k;
  const float* vr = v + (row * tiles + t0) * k;
  const int* ir = idx + row * tiles * k;

  for (int p = tid; p < c; p += THREADS) {
    const int tile = p / k;
    keys[(p - tile * k) * nt + tile] =
        __float_as_int(__fadd_rn(vr[p], 2.0f)) & ~0x7FF;
  }
  __syncthreads();

  for (int j = 0; j < out_k; ++j) {
    long long best = LLONG_MIN;
    for (int r = tid; r < c; r += THREADS)
      best = max64(best, word_of(keys[r], (unsigned)r));
    best = block_max(best, warp_best);
    const int qkey = (int)(best >> 32);
    const unsigned lpos = 0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFll);
    if (qkey > 0 && lpos % THREADS == (unsigned)tid) keys[lpos] = INT_MIN;
    if (tid == 0) {
      const unsigned slot = lpos / nt;
      const unsigned rank = slot * tiles + t0 + (lpos - slot * nt);
      const size_t o = row * out_k + j;
      if (FINAL)
        decode(qkey, rank, ir, tiles, k, out_v + o, out_i + o);
      else
        words[(row * gridDim.y + chunk) * out_k + j] = word_of(qkey, rank);
    }
    __syncthreads();  // the removal is seen and warp_best is free again
  }
}

// Pass 2: block `row` merges the chunks' [chunks * out_k] words.
__global__ void __launch_bounds__(THREADS)
merge_words_kernel(const long long* __restrict__ words, const int* __restrict__ idx,
                   float* __restrict__ out_v, int* __restrict__ out_i, int tiles,
                   int k, int out_k, int chunks) {
  extern __shared__ long long cand[];  // [chunks * out_k]
  __shared__ long long warp_best[WARPS];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int c = chunks * out_k;
  const long long* wr = words + row * c;
  const int* ir = idx + row * tiles * k;

  for (int p = tid; p < c; p += THREADS) cand[p] = wr[p];
  __syncthreads();

  for (int j = 0; j < out_k; ++j) {
    long long best = LLONG_MIN;
    for (int p = tid; p < c; p += THREADS) best = max64(best, cand[p]);
    best = block_max(best, warp_best);
    const int qkey = (int)(best >> 32);
    // A word with qkey > 0 names one candidate, so it is held once.
    if (qkey > 0)
      for (int p = tid; p < c; p += THREADS)
        if (cand[p] == best) cand[p] = LLONG_MIN;
    if (tid == 0) {
      const size_t o = row * out_k + j;
      decode(qkey, 0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFll), ir, tiles, k,
             out_v + o, out_i + o);
    }
    __syncthreads();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers:
//   v [b, tiles, k] f32, idx [b, tiles, k] int32 (B1's candidates),
//   out_v [b, out_k] f32, out_i [b, out_k] int32; with chunk_tiles < tiles,
//   words [b, ceil(tiles / chunk_tiles), out_k] int64 scratch (else null).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int packed_candidate_merge(const void* v, const void* idx,
                                      void* out_v, void* out_i, void* words,
                                      int b, int tiles, int k, int out_k,
                                      int chunk_tiles, void* stream) {
  if (b <= 0 || tiles <= 0 || k <= 0 || out_k < 1 || out_k > tiles * k ||
      chunk_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  const size_t smem1 = sizeof(int) * (size_t)(tiles < chunk_tiles ? tiles : chunk_tiles) * k;
  const size_t smem2 = sizeof(long long) * (size_t)chunks * out_k;
  const size_t fixed = sizeof(long long) * WARPS;
  if (smem1 + fixed > MAX_SMEM || chunks > 65535 ||
      (chunks > 1 && (words == nullptr || smem2 + fixed > MAX_SMEM)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(b, chunks);
  cudaError_t err;
  if (chunks == 1) {
    err = allow_smem(merge_chunk_kernel<true>, smem1);
    if (err != cudaSuccess) return (int)err;
    merge_chunk_kernel<true><<<grid, THREADS, smem1, s>>>(
        (const float*)v, (const int*)idx, (float*)out_v, (int*)out_i, nullptr,
        tiles, k, out_k, chunk_tiles);
    return (int)cudaGetLastError();
  }
  err = allow_smem(merge_chunk_kernel<false>, smem1);
  if (err != cudaSuccess) return (int)err;
  merge_chunk_kernel<false><<<grid, THREADS, smem1, s>>>(
      (const float*)v, (const int*)idx, nullptr, nullptr, (long long*)words, tiles,
      k, out_k, chunk_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(merge_words_kernel, smem2);
  if (err != cudaSuccess) return (int)err;
  merge_words_kernel<<<b, THREADS, smem2, s>>>(
      (const long long*)words, (const int*)idx, (float*)out_v, (int*)out_i, tiles, k,
      out_k, chunks);
  return (int)cudaGetLastError();
}
