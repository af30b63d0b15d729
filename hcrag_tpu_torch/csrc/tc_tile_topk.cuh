// tc_tile_topk.cuh — the tensor-core kernel of the per-tile top-k: kernels
// B1, B7i and B3e over an int8 bank (int8_tile_topk.cu) and B5, B7f and B4
// over a bf16 bank (float_tile_topk.cu).  The dots run on the tensor cores
// (tc_mma.cuh), the selection in their epilogue; the key policy and the
// operand type are template arguments, so the six kernels share one loop.
// The loop's body is tc_tile_topk_loop.cuh, which each __global__ that runs
// it includes: tc_tile_topk_kernel here, and float_tile_topk_kernel_tc in
// float_tile_topk.cu, whose name keeps B4's.  So each kernel compiles the
// loop as its own body (a device function that both inline would schedule
// B3e's code otherwise than the kernel alone does).
//
// A block takes TQB queries (128, or 64 where 128 do not fit shared memory)
// and one tile, with two consumer warpgroups (one for TQB = 64) and a
// producer warp.  The queries stay in shared memory for the whole tile,
// copied by cp.async into the swizzled layout (columns past d as zeros); the
// tile streams through a ring of STAGES chunks of 64 rows x 128 bytes: the
// producer keeps STAGES TMA copies in flight, each completing on its slot's
// `full` mbarrier (the TMA fills rows past the bank and columns past d with
// zeros, which add nothing to a sum), and refills a slot once all consumer
// warps have arrived on its `empty` mbarrier, so the warpgroups never wait
// for each other.  Warpgroup g sums queries 64 g .. + 63 with the 64 rows of
// each sub-tile by wgmma (m64n64, four 32-byte k-steps a chunk: k16 over
// bf16 with f32 sums, k32 over int8 with int32 sums; both operands from
// shared memory, the sums in registers), a sub-tile's chunks chained on the
// tensor cores; each warp so holds all 64 sums of 16 queries, and loads the
// mask bytes (and, over int8, the row scales) of its rows with the
// sub-tile's first chunk; over int8 each thread keeps its two queries'
// scales in registers.  After a sub-tile's last chunk each thread builds its
// keys with the policy's `make` (over int8 from the int32 sum and both
// scales) and keeps only those above its query's running k-th best key for
// this tile:
//   * k <= 16 (KCAP): each thread keeps, for each of its 2 queries, the
//     best keys of the rows it holds (a quarter of the tile) as a sorted
//     list of 16 in registers, which a key joins by a branch-free shift.
//     A key must beat the list's k-th entry and a bound the quad of lanes
//     that share the query agree on after each sub-tile (at least k of the
//     tile's keys lie above it), so few keys join after the first
//     sub-tile.  At the tile's end a warp sorts each query's four lists
//     (64 keys, tile_select::sort64_desc) and keeps the first k;
//   * larger k: the key goes to the query's buffer in shared memory, and
//     each warp merges the buffers of its 16 queries that have any into
//     their sorted lists (tile_select::merge_pair).
// The key is 32 bits (B1, B7i, B5, B7f) or 64 bits (B3e over int8, B4 over
// bf16: the order-preserving value word above 0xFFFFFFFF - row), a property
// of the policy's `Key` type; the lists, filters, buffers and tile-end sort
// take that type.  64-bit register lists hold 10 keys in 128-query blocks
// (k <= 10) and 16 in 64-query blocks (k <= 16; see list_cap).  A 64-bit
// epilogue computes the 32-bit value words (`policy.word`: over int8 from
// the int32 sum and both scales, over bf16 from the f32 sum alone) of its
// 32 sums and compares them with its filters' high halves first: the
// 64-bit key (`K::key(word, row)`) is built, and compared in full, only for
// the few rows whose word reaches the filter.  The 64-bit code sits behind
// `if constexpr`, so the 32-bit instances hold none of it.
// Rows past the tile's end never enter a list; their slots stay fillers.
// DOTS writes the raw sums to out_v ([b, n]) instead: the loop's own
// numbers, for measuring its error (bf16 only).  Blocks are ordered query
// block fastest, so the query blocks of one tile read it from L2.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_mma.cuh"
#include "tile_select.cuh"

namespace tc_tile {

constexpr int RB = 64;              // rows per sub-tile
constexpr int STAGES = 4;           // chunks in the ring
constexpr int CHUNK = RB * 128;     // bytes of one chunk: 64 rows x 128 bytes
constexpr int KCAP = 16;            // the register lists' length
constexpr int KCAP_WIDE = 10;       // the same for 64-bit keys in 128-query blocks
constexpr int MAX_K = tile_select::MAX_K;
constexpr int MAX_SMEM = 232448;    // what one block may use on sm_90

// The operand types.  `depth_ok` is the rule on d: bf16 rows of whole
// 64-column chunks; int8 rows of 16-byte multiples, and at most 1040 columns
// so that |dot| <= 127^2 * d < 2^24 and fp32(dot) is exact.
struct Bf16 {
  using Acc = float;
  static constexpr int BYTES = 2;
  static constexpr bool SCALED = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static bool depth_ok(int d) { return d > 0 && d % 64 == 0; }
};
struct Int8 {
  using Acc = int;
  static constexpr int BYTES = 1;
  static constexpr bool SCALED = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static bool depth_ok(int d) { return d > 0 && d % 16 == 0 && d <= 1040; }
};

// 128-byte chunks of one row.
__host__ __device__ inline int row_chunks(int d, int bytes) { return (d * bytes + 127) / 128; }

// Shared memory, with 1024 bytes to align the operands to the swizzle's
// 1024-byte atoms: the query block, the ring with its two mbarriers a slot,
// the key buffers and the lists (key_bytes a key), and the counts.
inline size_t smem_bytes(int qb, int d, int bytes, int k, size_t key_bytes) {
  return 1024 + (size_t)qb * row_chunks(d, bytes) * 128 + (size_t)STAGES * (CHUNK + 16) +
         key_bytes * ((size_t)qb * RB + (size_t)qb * k) + sizeof(int) * qb;
}

// Insert x into the descending register list v (its last entry below x).
template <typename Key, int N>
__device__ __forceinline__ void reg_insert(Key (&v)[N], Key x) {
#pragma unroll
  for (int i = N - 1; i > 0; --i) v[i] = v[i - 1] < x ? v[i - 1] : (v[i] < x ? x : v[i]);
  v[0] = v[0] < x ? x : v[0];
}

template <typename Key, int N>
__device__ __forceinline__ Key reg_kth(const Key (&v)[N], int k) {
  Key t = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i == k - 1) t = v[i];
  return t;
}

// v[x] for a run-time x, by selects: v stays in registers.
__device__ __forceinline__ int pick16(const int (&v)[16], int x) {
  int r = v[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) r = x == i ? v[i] : r;
  return r;
}

// The least of x over the 4 lanes of this lane's quad.
__device__ __forceinline__ int quad_min(int x) {
  x = min(x, __shfl_xor_sync(tile_select::FULL, x, 1));
  return min(x, __shfl_xor_sync(tile_select::FULL, x, 2));
}

__device__ __forceinline__ long long quad_min(long long x) {
  x = min(x, __shfl_xor_sync(tile_select::FULL, x, 1));
  return min(x, __shfl_xor_sync(tile_select::FULL, x, 2));
}

template <int TQB, int KC, typename Op, typename K, bool DOTS>
__global__ void __launch_bounds__(TQB * 2 + 32)
tc_tile_topk_kernel(const __grid_constant__ CUtensorMap emap,
                    const unsigned char* __restrict__ q, const float* __restrict__ q_scale,
                    const float* __restrict__ e_scale, const uint8_t* __restrict__ mask,
                    float* __restrict__ out_v, int* __restrict__ out_i, int b, int n, int d,
                    int k, int tile_n, int tiles, const K policy) {
#include "tc_tile_topk_loop.cuh"
}

// Which __global__ a launch runs: `Kernels::get<TQB, KC, Op, K, DOTS>()`.
// This one gives tc_tile_topk_kernel; float_tile_topk.cu's B4Kernels gives
// B4's.
struct TcKernels {
  template <int TQB, int KC, typename Op, typename K, bool DOTS>
  static auto get() { return tc_tile_topk_kernel<TQB, KC, Op, K, DOTS>; }
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of the bank: boxes of 64 rows x 128 bytes, 128-byte swizzle;
// rows past the bank and columns past d read as zeros.  Encoded through the
// runtime's driver entry point, so the library needs no -lcuda.
template <typename Op>
int tensor_map(const void* e, int n, int d, CUtensorMap* emap) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t stride[1] = {(cuuint64_t)d * Op::BYTES};
  const cuuint32_t box[2] = {128 / Op::BYTES, RB};
  const cuuint32_t one[2] = {1, 1};
  if (encode(emap, Op::MAP, 2, const_cast<void*>(e), dims, stride, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The operands of one launch; the scales are null over bf16.
struct Args {
  const void* q;
  const void* q_scale;
  const void* e;
  const void* e_scale;
  const void* mask;
  void* out_v;
  void* out_i;
  int b, n, d, k, tile_n, tiles;
  void* stream;
};

template <int TQB, int KC, typename Op, typename K, bool DOTS, typename Kernels>
int launch_kernel(const K policy, const CUtensorMap& emap, const Args& a, size_t smem) {
  auto kernel = Kernels::template get<TQB, KC, Op, K, DOTS>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.b + TQB - 1) / TQB, a.tiles);
  kernel<<<grid, TQB * 2 + 32, smem, (cudaStream_t)a.stream>>>(
      emap, (const unsigned char*)a.q, (const float*)a.q_scale, (const float*)a.e_scale,
      (const uint8_t*)a.mask, (float*)a.out_v, (int*)a.out_i, a.b, a.n, a.d, a.k, a.tile_n,
      a.tiles, policy);
  return (int)cudaGetLastError();
}

// The register lists' length: KCAP, but for 64-bit keys in 128-query
// blocks KCAP_WIDE.  Those blocks' 9 warps (3 on some of the SM's four
// schedulers) leave a thread 168 registers, where 16 64-bit keys a list
// spill; 64-query blocks (5 warps) leave 255, so 64-bit keys at
// KCAP_WIDE < k <= KCAP take those.
template <int TQB, typename K>
constexpr int list_cap() {
  return sizeof(typename K::Key) == 8 && TQB == 128 ? KCAP_WIDE : KCAP;
}

template <int TQB, typename Op, typename K, bool DOTS, typename Kernels>
int launch_k(const K policy, const CUtensorMap& emap, const Args& a) {
  constexpr int CAP = list_cap<TQB, K>();
  const size_t smem = smem_bytes(TQB, a.d, Op::BYTES, a.k, sizeof(typename K::Key));
  if (a.k <= CAP) return launch_kernel<TQB, CAP, Op, K, DOTS, Kernels>(policy, emap, a, smem);
  return launch_kernel<TQB, 0, Op, K, DOTS, Kernels>(policy, emap, a, smem);
}

// The queries a block takes: 128 where they fit shared memory, else 64; 0
// where neither fits.  64-bit keys at KCAP_WIDE < k <= KCAP take 64 (their
// register lists of 16; see list_cap).  topk_cuda.tc_block_queries states
// the same rule.
template <typename Op>
inline int block_queries(int d, int k, size_t key_bytes) {
  const bool only_64 = key_bytes == 8 && KCAP_WIDE < k && k <= KCAP;
  if (!only_64 && smem_bytes(128, d, Op::BYTES, k, key_bytes) <= MAX_SMEM) return 128;
  return smem_bytes(64, d, Op::BYTES, k, key_bytes) <= MAX_SMEM ? 64 : 0;
}

// Check the operands and launch the kernel with the widest query block that
// fits.  `max_tile` is 2048 for B1, B3e, B4 and B5 (an 11-bit lane field;
// B3e and B4 keep B1's tiles) and 8192 for B7i and B7f.
template <typename Op, typename K, bool DOTS, typename Kernels = TcKernels>
int launch(const K policy, Args a, int max_tile) {
  if (a.b <= 0 || a.n <= 0 || !Op::depth_ok(a.d) || a.k < 1 || a.k > MAX_K ||
      a.k > a.tile_n || a.tile_n % RB != 0 || a.tile_n > max_tile || (size_t)a.q % 16 != 0 ||
      (size_t)a.e % 16 != 0 || (size_t)a.mask % 4 != 0 || (size_t)a.e_scale % 8 != 0)
    return (int)cudaErrorInvalidValue;
  a.tiles = (a.n + a.tile_n - 1) / a.tile_n;
  if (a.tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap emap;
  const int err = tensor_map<Op>(a.e, a.n, a.d, &emap);
  if (err) return err;
  switch (block_queries<Op>(a.d, a.k, sizeof(typename K::Key))) {
    case 128: return launch_k<128, Op, K, DOTS, Kernels>(policy, emap, a);
    case 64: return launch_k<64, Op, K, DOTS, Kernels>(policy, emap, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc_tile
