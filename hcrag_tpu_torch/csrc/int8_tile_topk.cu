// int8_tile_topk — kernel B1 of the port: int8 cosine scores and the exact
// top-k of every 2048-row index tile under the packed (score | lane) key.
//
// Replaces `_topk_tile_kernel_int8` (hcrag_tpu/ops/topk_pallas.py), launched
// by `pallas_cosine_top_k_int8`.  Its contract is the exact per-tile top-k of
// the packed branch: for query b and row n of tile t
//
//   s   = fp32(dot_i32(q[b], e[n])) * q_scale[b] * e_scale[n]
//         + (mask[n] ? 2.0 : -3.0)                  (in exactly this order)
//   key = (bits(s) & ~0x7FF) | (2047 - (n - t * tile_n))    as int32
//
// and the k largest keys of the tile decode to
//   val = float(key & ~0x7FF) - 2.0,  idx = 2047 - (key & 0x7FF) + t * tile_n
// with a key <= 0 (masked row, row past n, or no row left) decoding to the
// filler (-1e30, -1).  Keys are unique within a tile, so the result is fully
// determined and equals the plain PyTorch version bit for bit.  The rescale
// and shift use __fmul_rn / __fadd_rn (and the build passes --fmad=false):
// an FMA would change the key bits.
//
// What bounds it on an H100: at the main path's shape (B = 8192 queries,
// N = 1,001,472 rows, D = 384) it does 2*B*N*D = 6.3e12 int8 operations
// (3.2 ms at the 1,979 TOP/s int8 tensor-core peak) and must move ~0.7 GB
// (the 385 MB bank, the candidates it writes: ~0.2 ms at 3.35 TB/s), so it
// is bound by operations.  This first version computes the dots with __dp4a
// on the CUDA cores, not the tensor cores, and so sits far above that bound;
// wgmma and TMA are the next step.
//
// Design: one block takes QB = 64 queries and one tile.  The query block
// stays in shared memory; the tile streams through shared memory in
// sub-tiles of RB = 64 rows.  256 threads each compute a 4 x 4 block of
// dots with 16-byte shared loads and __dp4a, write the packed keys to shared
// memory, and then each warp filters the keys of its 8 queries against the
// current k-th best (a warp ballot) and inserts the few survivors into that
// query's sorted list in shared memory (tile_select.cuh, shared with B4 and
// B5).  Blocks are ordered query block fastest, so all query blocks of one
// tile run together and read the tile from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_select.cuh"

namespace {

constexpr int QB = 64;          // queries per block
constexpr int RB = 64;          // index rows per staged sub-tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 dots each
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QB / WARPS;
constexpr int KEY_STRIDE = 68;  // ints per query row of the key buffer
constexpr int MAX_K = tile_select::MAX_K;

__device__ __forceinline__ int packed_key(int dot, float qs, float es,
                                          bool valid, int lane_field) {
  float s = __fmul_rn(__fmul_rn(__int2float_rn(dot), qs), es);
  s = __fadd_rn(s, valid ? 2.0f : -3.0f);
  return (__float_as_int(s) & ~0x7FF) | lane_field;
}

__global__ void __launch_bounds__(THREADS)
int8_tile_topk_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ q_scale,
                      const int8_t* __restrict__ e,
                      const float* __restrict__ e_scale,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      int b, int n, int d, int k, int tile_n, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = d + 16;  // padded rows spread the shared banks
  int8_t* q_rows = reinterpret_cast<int8_t*>(smem);
  int8_t* e_rows = q_rows + QB * row_bytes;
  int* keys = reinterpret_cast<int*>(e_rows + RB * row_bytes);
  int* lists = keys + QB * KEY_STRIDE;
  float* qscale_s = reinterpret_cast<float*>(lists + QB * k);
  float* escale_s = qscale_s + QB;
  int* valid_s = reinterpret_cast<int*>(escale_s + RB);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tq = tid >> 4;  // queries tq*4 .. tq*4+3
  const int tr = tid & 15;  // rows tr, tr+16, tr+32, tr+48 of the sub-tile
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int tile_base = tile * tile_n;
  const int chunks = d / 16;

  for (int x = tid; x < QB * chunks; x += THREADS) {
    const int r = x / chunks, c = x - r * chunks;
    int4 v = make_int4(0, 0, 0, 0);
    if (q0 + r < b)
      v = reinterpret_cast<const int4*>(q + (size_t)(q0 + r) * d)[c];
    *reinterpret_cast<int4*>(q_rows + r * row_bytes + c * 16) = v;
  }
  for (int x = tid; x < QB; x += THREADS)
    qscale_s[x] = q0 + x < b ? q_scale[q0 + x] : 0.0f;
  for (int x = tid; x < QB * k; x += THREADS) lists[x] = 0;  // filler key

  for (int sub = 0; sub < tile_n && tile_base + sub < n; sub += RB) {
    __syncthreads();  // the previous sub-tile's keys and rows are consumed
    for (int x = tid; x < RB * chunks; x += THREADS) {
      const int r = x / chunks, c = x - r * chunks;
      const int row = tile_base + sub + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (row < n) v = reinterpret_cast<const int4*>(e + (size_t)row * d)[c];
      *reinterpret_cast<int4*>(e_rows + r * row_bytes + c * 16) = v;
    }
    if (tid < RB) {
      const int row = tile_base + sub + tid;
      const bool in = row < n;
      escale_s[tid] = in ? e_scale[row] : 0.0f;
      valid_s[tid] = in && mask[row] != 0;
    }
    __syncthreads();

    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int c = 0; c < chunks; ++c) {
      int4 qv[4], ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const int4*>(
            q_rows + (tq * 4 + i) * row_bytes + c * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ev[j] = *reinterpret_cast<const int4*>(
            e_rows + (tr + 16 * j) * row_bytes + c * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int a = acc[i][j];
          a = __dp4a(qv[i].x, ev[j].x, a);
          a = __dp4a(qv[i].y, ev[j].y, a);
          a = __dp4a(qv[i].z, ev[j].z, a);
          a = __dp4a(qv[i].w, ev[j].w, a);
          acc[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qq = tq * 4 + i, r = tr + 16 * j;
        keys[qq * KEY_STRIDE + r] =
            packed_key(acc[i][j], qscale_s[qq], escale_s[r], valid_s[r] != 0,
                       2047 - (sub + r));
      }
    __syncthreads();

    for (int qq = warp * Q_PER_WARP; qq < (warp + 1) * Q_PER_WARP; ++qq)
      tile_select::merge_64(keys + qq * KEY_STRIDE, lists + qq * k, k, lane);
  }

  for (int qq = warp * Q_PER_WARP; qq < (warp + 1) * Q_PER_WARP; ++qq) {
    const int gq = q0 + qq;
    if (gq >= b) break;
    const int* L = lists + qq * k;
    for (int j = lane; j < k; j += 32) {
      const int key = L[j];
      const size_t o = ((size_t)gq * tiles + tile) * k + j;
      if (key > 0) {
        out_v[o] = __fsub_rn(__int_as_float(key & ~0x7FF), 2.0f);
        out_i[o] = tile_base + 2047 - (key & 0x7FF);
      } else {
        out_v[o] = -1e30f;
        out_i[o] = -1;
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers:
//   q [b, d] int8, q_scale [b] f32, e [n, d] int8, e_scale [n] f32,
//   mask [n] bool (one byte each), out_v [b, tiles, k] f32,
//   out_i [b, tiles, k] int32, with tiles = ceil(n / tile_n).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int int8_tile_topk(const void* q, const void* q_scale,
                              const void* e, const void* e_scale,
                              const void* mask, void* out_v, void* out_i,
                              int b, int n, int d, int k, int tile_n,
                              void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % 16 != 0 || k < 1 || k > MAX_K ||
      k > tile_n || tile_n % RB != 0 || tile_n > 2048)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile_n - 1) / tile_n;
  const size_t smem = (size_t)(QB + RB) * (d + 16) +
                      sizeof(int) * (size_t)QB * (KEY_STRIDE + k) +
                      sizeof(float) * (QB + RB) + sizeof(int) * RB;
  cudaError_t err = cudaFuncSetAttribute(
      int8_tile_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QB - 1) / QB, tiles);
  int8_tile_topk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)q_scale, (const int8_t*)e,
      (const float*)e_scale, (const uint8_t*)mask, (float*)out_v,
      (int*)out_i, b, n, d, k, tile_n, tiles);
  return (int)cudaGetLastError();
}
