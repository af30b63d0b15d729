// kernel_sweep.cu — kernel B8 of the port: the three stage-attribution
// kernels of the kernel sweep, which split the time of the port's fused float
// top-k on the CUDA cores (B4, and B5 over an f32 bank) into its stages.
//
// They replace `make_matmul_only_acc` (B8a), `make_matmul_only_wide` (B8b)
// and `make_encode_level1` (B8c) in benchmarks/kernel_sweep.py.  For queries
// q [b, d] and a bank e [n, d], both bf16, with n a whole number of tiles of
// tile_n rows (a multiple of 128, at most 2048), let s = q . e^T in f32 (the
// products of bf16 values are exact; the sums run in float_dot.cuh's order).
//
//   B8a, matmul_only_acc:  out [b, 128] f32,
//       out[b, j] = max(-1e30, max over tiles t of s[b, t * tile_n + j]);
//   B8b, matmul_only_wide: out [b, tiles * 128] f32,
//       out[b, t * 128 + j] = s[b, t * tile_n + j];
//   B8c, encode_level1:    out [b, 256] int32.  Under the packed key
//       key = (bits(s + 2) & ~0x7FF) | (2047 - col)   (col: the row's place
//       in its tile; s + 2 by __fadd_rn, and the build passes --fmad=false),
//       for each lane l < 128 let m1 be the largest and m2 = max(0, the
//       second-largest) key over the tile's groups g (col = g * 128 + l);
//       out[b, l] = max(0, max over tiles of m1) and
//       out[b, 128 + l] = max(0, max over tiles of m2).
//
// Every kernel computes every dot of s, which is the work the sweep times.
// In B8a and B8b only the first 128 columns of a tile reach the output, and
// nvcc drops arithmetic that feeds nothing; so each thread folds the bits of
// the other dots into a register that it stores only when the kernel is
// given a `sink` buffer, which the C entry points never give it.
//
// What bounds them on an H100: at the sweep's shapes (b = 512,
// n = 1,001,472, d = 384) they do 2*b*n*d = 3.9e11 operations, 0.398 ms at
// the 989 TFLOP/s bf16 tensor-core rate, against a 0.77 GB bank (0.23 ms at
// 3.35 TB/s) and, for B8b, 128 MB of output: bound by operations.  They run
// the CUDA-core dot loop (float_dot.cuh), far above that bound, on purpose:
// their times are the floor of that loop and of its stages (B5 over a bf16
// bank runs on the tensor cores and is timed beside them).
//
// Design: the CUDA-core kernel's grid and loop.  A block takes 64 queries and 2048 rows: one
// tile of 2048 rows (B5's block), or 2048 / tile_n whole tiles of a smaller
// tile, so that a block's work does not depend on tile_n.  Each thread
// (tq, tr) owns columns tr + 16j and 64 + tr + 16j (j < 4) of every
// 128-column group, for its 4 queries.  B8c folds m1 and m2 through a tile's
// groups in registers; B8a's running maxima and B8c's running max over the
// block's tiles sit in shared memory, in slots that only that thread
// touches, which keeps the fold out of the dot loop's registers.  The max
// over blocks is an atomic max into the output, which the wrapper fills
// first (B8a: -1e30, B8c: 0); a block skips the atomic where the output
// already holds at least its value, so that the ~489 blocks that fold into
// each output word at the sweep's shapes do not queue on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_dot.cuh"

namespace {

using float_dot::DC;
using float_dot::E_STRIDE;
using float_dot::QB;
using float_dot::RB;
using float_dot::THREADS;
constexpr int LANES = 128;        // output columns per tile (B8a, B8b); lanes (B8c)
constexpr int BLOCK_ROWS = 2048;  // index rows per block: B5's tile
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

enum Stage { ACC = 0, WIDE = 1, ENCODE = 2 };

// out = max(out, v) for floats that are not NaN: a non-negative float orders
// as its int bits, a negative one inversely to its unsigned bits.
__device__ __forceinline__ void atomic_max_f32(float* out, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(out), __float_as_uint(v));
}

// The thread's running max of columns h * 64 + tr + 16j (B8a): query row r
// of the block at lane_max[r * 128 + column].
__device__ __forceinline__ void fold_max(float* lane_max, const float (&acc)[4][4], int tq,
                                         int tr, int h) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* slot = lane_max + (tq * 4 + i) * LANES + h * 64 + tr + 16 * j;
      *slot = fmaxf(*slot, acc[i][j]);
    }
}

// One group's keys into the level-1 pair: the first group of a tile starts
// it (m2 = 0), every later one updates it as the Pallas kernel does.
__device__ __forceinline__ void level1(int (&m1)[4][4], int (&m2)[4][4],
                                       const float (&acc)[4][4], int col0, bool first) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = (__float_as_int(__fadd_rn(acc[i][j], 2.0f)) & ~0x7FF) |
                      (2047 - (col0 + 16 * j));
      if (first) {
        m1[i][j] = key;
        m2[i][j] = 0;
      } else {
        m2[i][j] = max(m2[i][j], min(m1[i][j], key));
        m1[i][j] = max(m1[i][j], key);
      }
    }
}

// The thread's running max over the block's tiles (B8c): query row r of
// the block, lanes h * 64 + tr + 16j, m1 at lane, m2 at 128 + lane.
__device__ __forceinline__ void fold_best(int* best, const int (&m1)[4][4],
                                          const int (&m2)[4][4], int tq, int tr, int h) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int* slot = best + (tq * 4 + i) * 2 * LANES + h * 64 + tr + 16 * j;
      slot[0] = max(slot[0], m1[i][j]);
      slot[LANES] = max(slot[LANES], m2[i][j]);
    }
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ e,
             void* __restrict__ out, int* __restrict__ sink, int b, int d, int tile_n,
             int tiles, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_rows = reinterpret_cast<float*>(smem);  // float_dot's layout
  float* e_rows = q_rows + QB * (d + 4);
  float* lane_max = e_rows + RB * E_STRIDE;             // B8a: [QB][128]
  int* best = reinterpret_cast<int*>(e_rows + RB * E_STRIDE);  // B8c: [QB][256]

  const int tid = threadIdx.x;
  const int tq = tid >> 4;  // queries tq*4 .. tq*4+3
  const int tr = tid & 15;  // columns tr, tr+16, tr+32, tr+48 of a sub-tile
  const int q0 = blockIdx.x * QB;
  const int t_first = blockIdx.y * tiles_per_block;
  const int t_end = min(tiles, t_first + tiles_per_block);

  float_dot::stage_queries(q, q_rows, q0, b, d);
  // B8c: m1 and m2 of lanes tr + 16j (lo) and 64 + tr + 16j (hi).
  int lo_m1[4][4], lo_m2[4][4], hi_m1[4][4], hi_m2[4][4];
  // The first barrier of sub_tile_dots publishes these.
  if (STAGE == ACC)
    for (int x = tid; x < QB * LANES; x += THREADS) lane_max[x] = -1e30f;
  if (STAGE == ENCODE)
    for (int x = tid; x < QB * 2 * LANES; x += THREADS) best[x] = 0;
  int dead = 0;  // the fold of the dots that reach no output (B8a, B8b)

  for (int t = t_first; t < t_end; ++t) {
    for (int sub = 0; sub < tile_n; sub += RB) {
      float acc[4][4];
      float_dot::sub_tile_dots(e, q_rows, e_rows, d, t * tile_n, sub, tile_n, acc,
                               [](int) {});
      const int h = (sub / RB) & 1;  // which half of its 128-column group
      if (STAGE == ENCODE) {
        const bool first = sub < LANES;
        if (h == 0)
          level1(lo_m1, lo_m2, acc, sub + tr, first);
        else
          level1(hi_m1, hi_m2, acc, sub + tr, first);
      } else if (sub >= LANES) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dead ^= __float_as_int(acc[i][j]);
      } else if (STAGE == ACC) {
        fold_max(lane_max, acc, tq, tr, h);
      } else {  // WIDE
        float* o = static_cast<float*>(out);
        const size_t width = (size_t)tiles * LANES;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gq = q0 + tq * 4 + i;
          if (gq >= b) break;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[gq * width + (size_t)t * LANES + sub + tr + 16 * j] = acc[i][j];
        }
      }
    }
    if (STAGE == ENCODE) {
      fold_best(best, lo_m1, lo_m2, tq, tr, 0);
      fold_best(best, hi_m1, hi_m2, tq, tr, 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq * 4 + i;
    if (q0 + r >= b) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lane = h * 64 + tr + 16 * j;
        // The output only grows, so a value at or below what the output
        // holds (or held: an older value is smaller) needs no atomic.
        if (STAGE == ACC) {
          float* o = static_cast<float*>(out) + (size_t)(q0 + r) * LANES + lane;
          const float v = lane_max[r * LANES + lane];
          if (v > __ldcg(o)) atomic_max_f32(o, v);
        } else if (STAGE == ENCODE) {
          int* o = static_cast<int*>(out) + (size_t)(q0 + r) * 2 * LANES + lane;
          const int m1 = best[r * 2 * LANES + lane];
          const int m2 = best[r * 2 * LANES + LANES + lane];
          if (m1 > __ldcg(o)) atomicMax(o, m1);
          if (m2 > __ldcg(o + LANES)) atomicMax(o + LANES, m2);
        }
      }
  }
  if (sink != nullptr) sink[blockIdx.y * gridDim.x * THREADS + blockIdx.x * THREADS + tid] = dead;
}

template <int STAGE>
int launch(const void* q, const void* e, void* out, int b, int n, int d, int tile_n,
           void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % DC != 0 || tile_n < LANES ||
      tile_n > BLOCK_ROWS || tile_n % LANES != 0 || n % tile_n != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = n / tile_n;
  const int tiles_per_block = BLOCK_ROWS / tile_n;
  const int blocks_y = (tiles + tiles_per_block - 1) / tiles_per_block;
  const size_t smem = sizeof(float) * float_dot::smem_floats(d) +
                      (STAGE == ACC ? sizeof(float) * QB * LANES
                       : STAGE == ENCODE ? sizeof(int) * QB * 2 * LANES : 0);
  if (blocks_y > 65535 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QB - 1) / QB, blocks_y);
  sweep_kernel<STAGE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)e, out, nullptr, b, d, tile_n,
      tiles, tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers: q [b, d]
// and e [n, d] bf16; out as above, filled by the caller first (B8a: -1e30,
// B8c: 0; B8b: any).  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int matmul_only_acc(const void* q, const void* e, void* out, int b, int n,
                               int d, int tile_n, void* stream) {
  return launch<ACC>(q, e, out, b, n, d, tile_n, stream);
}

extern "C" int matmul_only_wide(const void* q, const void* e, void* out, int b, int n,
                                int d, int tile_n, void* stream) {
  return launch<WIDE>(q, e, out, b, n, d, tile_n, stream);
}

extern "C" int encode_level1(const void* q, const void* e, void* out, int b, int n,
                             int d, int tile_n, void* stream) {
  return launch<ENCODE>(q, e, out, b, n, d, tile_n, stream);
}
