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
// Design: the CUDA-core kernel's grid and loop (float_dot.cuh).  A block
// takes 128 queries and 2048 rows: one tile of 2048 rows (B5's block), or
// 2048 / tile_n whole tiles of a smaller tile, run as one stream of 128-row
// sub-tiles, so that a block's work does not depend on tile_n.  A sub-tile
// is one 128-column group of its tile, and each thread owns lanes row_of(j)
// (j < 8) of every group for its 8 queries.  B8a's running maxima, B8c's
// level-1 pair (m1, m2) of the current tile, sit in shared memory, in slots
// that only that thread touches, which keeps the fold out of the dot loop's
// registers (B8c's 128 KB of pairs leave room for one block an SM, B8a's
// 64 KB of maxima for two, as B4's kernel has).  The max over blocks is an
// atomic max into the output, which the wrapper fills first (B8a: -1e30,
// B8c: 0), after the block's last tile (B8a) or after each tile (B8c); a
// thread skips the atomic where the output already holds at least its
// value, so that the ~489 blocks that fold into each output word at the
// sweep's shapes do not queue on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_dot.cuh"

namespace {

using float_dot::QB;
using float_dot::RB;
using float_dot::THREADS;
constexpr int LANES = 128;        // output columns per tile (B8a, B8b); lanes (B8c)
constexpr int BLOCK_ROWS = 2048;  // index rows per block: B5's tile
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90
static_assert(RB == LANES, "a sub-tile is one 128-column group");

enum Stage { ACC = 0, WIDE = 1, ENCODE = 2 };

// out = max(out, v) for floats that are not NaN: a non-negative float orders
// as its int bits, a negative one inversely to its unsigned bits.
__device__ __forceinline__ void atomic_max_f32(float* out, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(out), __float_as_uint(v));
}

// Shared memory past the loop's: B8a's maxima [QB][128] f32, B8c's pairs
// m1 [QB][128] and m2 [QB][128] int32.
size_t smem_bytes(int stage) {
  return float_dot::SMEM_BYTES +
         (stage == ACC ? sizeof(float) * QB * LANES
          : stage == ENCODE ? sizeof(int) * QB * 2 * LANES : 0);
}

// B8a and B8b take B4's two blocks an SM (and so its register cap); B8c's
// shared memory leaves room for one.
template <int STAGE>
__global__ void __launch_bounds__(THREADS, STAGE == ENCODE ? 1 : 2)
sweep_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ e,
             void* __restrict__ out, int* __restrict__ sink, int b, int d, int tile_n,
             int tiles, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lane_max = reinterpret_cast<float*>(smem + float_dot::SMEM_BYTES);  // B8a
  int* m1s = reinterpret_cast<int*>(smem + float_dot::SMEM_BYTES);           // B8c
  int* m2s = m1s + QB * LANES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int t_first = blockIdx.y * tiles_per_block;
  const int t_end = min(tiles, t_first + tiles_per_block);

  if (STAGE == ACC)
    for (int x = tid; x < QB * LANES; x += THREADS) lane_max[x] = -1e30f;
  int dead = 0;  // the fold of the dots that reach no output (B8a, B8b)

  // The tile_dots' first barrier publishes lane_max.
  float_dot::tile_dots(q, e, reinterpret_cast<float*>(smem), b, d, q0, t_first * tile_n,
                       (t_end - t_first) * tile_n, [&](float (&acc)[8][8], int sub) {
    const int t = t_first + sub / tile_n;
    const int col0 = sub % tile_n;  // the group's first column in its tile
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = float_dot::query_of(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lane = float_dot::row_of(j);
        if (STAGE == ENCODE) {
          // One group's key into the tile's level-1 pair: the first group
          // starts it (m2 = 0), every later one updates it as the Pallas
          // kernel does.
          const int key = (__float_as_int(__fadd_rn(acc[i][j], 2.0f)) & ~0x7FF) |
                          (2047 - (col0 + lane));
          int* m1 = m1s + r * LANES + lane;
          int* m2 = m2s + r * LANES + lane;
          if (col0 == 0) {
            *m1 = key;
            *m2 = 0;
          } else {
            *m2 = max(*m2, min(*m1, key));
            *m1 = max(*m1, key);
          }
        } else if (col0 != 0) {
          dead ^= __float_as_int(acc[i][j]);
        } else if (STAGE == ACC) {
          float* slot = lane_max + r * LANES + lane;
          *slot = fmaxf(*slot, acc[i][j]);
        } else if (q0 + r < b) {  // WIDE
          static_cast<float*>(out)[(size_t)(q0 + r) * tiles * LANES + (size_t)t * LANES +
                                   lane] = acc[i][j];
        }
      }
    }
    if (STAGE == ENCODE && col0 + RB == tile_n) {
      // The tile's pairs into the output.  The output only grows, so a
      // value at or below what it holds (or held: an older value is
      // smaller) needs no atomic.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = float_dot::query_of(i);
        if (q0 + r >= b) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int lane = float_dot::row_of(j);
          int* o = static_cast<int*>(out) + (size_t)(q0 + r) * 2 * LANES + lane;
          const int m1 = m1s[r * LANES + lane], m2 = m2s[r * LANES + lane];
          if (m1 > __ldcg(o)) atomicMax(o, m1);
          if (m2 > __ldcg(o + LANES)) atomicMax(o + LANES, m2);
        }
      }
    }
  });

  if (STAGE == ACC) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = float_dot::query_of(i);
      if (q0 + r >= b) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lane = float_dot::row_of(j);
        float* o = static_cast<float*>(out) + (size_t)(q0 + r) * LANES + lane;
        const float v = lane_max[r * LANES + lane];
        if (v > __ldcg(o)) atomic_max_f32(o, v);
      }
    }
  }
  if (sink != nullptr) sink[blockIdx.y * gridDim.x * THREADS + blockIdx.x * THREADS + tid] = dead;
}

template <int STAGE>
int launch(const void* q, const void* e, void* out, int b, int n, int d, int tile_n,
           void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % 64 != 0 || tile_n < LANES ||
      tile_n > BLOCK_ROWS || tile_n % LANES != 0 || n % tile_n != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = n / tile_n;
  const int tiles_per_block = BLOCK_ROWS / tile_n;
  const int blocks_y = (tiles + tiles_per_block - 1) / tiles_per_block;
  const size_t smem = smem_bytes(STAGE);
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
