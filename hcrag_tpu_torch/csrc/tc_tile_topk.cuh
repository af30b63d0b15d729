// tc_tile_topk.cuh — the tensor-core kernel of the packed per-tile top-k:
// kernels B1 and B7i over an int8 bank (int8_tile_topk.cu) and B5 and B7f
// over a bf16 bank (float_tile_topk.cu).  The dots run on the tensor cores
// (tc_mma.cuh), the selection in their epilogue; the key policy and the
// operand type are template arguments, so the four kernels share one loop.
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
// The key is 32 bits (B1, B7i, B5, B7f) or 64 bits (B3e, over int8: the
// order-preserving value word above 0xFFFFFFFF - row), a property of the
// policy's `Key` type; the lists, filters, buffers and tile-end sort take
// that type.  64-bit register lists hold 10 keys in 128-query blocks
// (k <= 10) and 16 in 64-query blocks (k <= 16; see list_cap).  A 64-bit
// epilogue computes the 32-bit value words (`policy.word`) of its 32 sums
// and compares them with its filters' high halves first: the 64-bit key
// (`K::key(word, row)`) is built, and compared in full, only for the few
// rows whose word reaches the filter.  The 64-bit code sits behind
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
  constexpr int NT = TQB * 2;    // the consumer warpgroups' threads
  constexpr int NW = NT / 32;
  constexpr int QPW = TQB / NW;  // queries each warp holds and merges: 16
  using Key = typename K::Key;
  constexpr bool WIDE = sizeof(Key) == 8;  // B3e: compare the value word first
  static_assert(!WIDE || Op::SCALED, "64-bit keys are B3e's, over int8");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int kc_n = row_chunks(d, Op::BYTES);
  unsigned char* q_s =                                // kc_n chunks of TQB rows
      smem_raw + ((1024 - (tc_mma::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + (size_t)TQB * kc_n * 128;  // STAGES chunks of 64 rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * CHUNK);  // full, empty
  Key* cand = reinterpret_cast<Key*>(bars + 2 * STAGES);  // [TQB][RB]
  Key* lists = cand + TQB * RB;                       // [TQB][k], sorted descending
  int* cnt = reinterpret_cast<int*>(lists + TQB * k);  // [TQB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int tile_base = tile * tile_n;
  const int rows_here = min(tile_n, n - tile_base);
  const int steps = (rows_here + RB - 1) / RB * kc_n;
  const uint32_t ring_addr = tc_mma::smem_addr(ring);
  const uint32_t full = tc_mma::smem_addr(bars);  // + 8 slot: chunk landed
  const uint32_t empty = full + 8 * STAGES;       // + 8 slot: every warp is done with it

  if (tid == 0) {
    for (int x = 0; x < STAGES; ++x) {
      tc_mma::mbar_init(full + 8 * x, 1);
      tc_mma::mbar_init(empty + 8 * x, NW);
    }
    tc_mma::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NW) {
    // The producer warp: lane 0 keeps STAGES chunks in flight, chunk s
    // (chunk s % kc_n of sub-tile s / kc_n) into slot s % STAGES once every
    // consumer warp has released the slot's previous chunk.
    if (lane == 0)
      for (int s = 0; s < steps; ++s) {
        const int slot = s % STAGES;
        if (s >= STAGES) tc_mma::mbar_wait(empty + 8 * slot, (s / STAGES - 1) & 1);
        tc_mma::mbar_expect(full + 8 * slot, CHUNK);
        tc_mma::tma_2d(ring_addr + slot * CHUNK, &emap, (s % kc_n) * (128 / Op::BYTES),
                       tile_base + (s / kc_n) * RB, full + 8 * slot);
      }
    return;
  }

  // The consumers: two warpgroups (one for TQB = 64).
  const int wg = warp >> 2;  // warpgroup: queries 64 wg .. 64 wg + 63
  const int qw = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and + 8: this thread's
  const int q0 = blockIdx.x * TQB;
  const uint32_t q_addr = tc_mma::smem_addr(q_s);
  // The query block, rows past b and segments past d as zeros.
  const int row_bytes = d * Op::BYTES;
  const int segs = row_bytes / 16, segs_pad = kc_n * 8;
  for (int x = tid; x < TQB * segs_pad; x += NT) {
    const int r = x / segs_pad, seg = x - r * segs_pad;
    const bool in = q0 + r < b && seg < segs;
    tc_mma::cp16(q_addr + (seg >> 3) * (TQB * 128) + tc_mma::swz(r, seg),
                 in ? (const void*)(q + (size_t)(q0 + r) * row_bytes + seg * 16)
                    : (const void*)q,
                 in ? 16 : 0);
  }
  tc_mma::cp_commit();
  if (!DOTS && KC == 0) {
    for (int x = tid; x < TQB * k; x += NT) lists[x] = K::filler();
    for (int x = tid; x < TQB; x += NT) cnt[x] = 0;
  }
  // Over int8: the scales of this thread's two queries (0 past b).
  float qs0 = 0.0f, qs1 = 0.0f;
  if constexpr (Op::SCALED) {
    if (q0 + qw < b) qs0 = q_scale[q0 + qw];
    if (q0 + qw + 8 < b) qs1 = q_scale[q0 + qw + 8];
  }
  tc_mma::cp_wait<0>();
  tc_mma::fence_async_smem();
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // the consumers only

  // acc[4 j + 2 h + c]: query qw + 8 h, row 8 j + 2 (lane % 4) + c of the
  // sub-tile (tc_mma::wgmma_64x64).
  typename Op::Acc acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0;
  constexpr int NL = KC > 0 ? KC : 1;
  Key l0[NL], l1[NL];  // KC: this thread's lists of its two queries
  Key t0 = K::filler(), t1 = K::filler();  // and their filters
#pragma unroll
  for (int i = 0; i < NL; ++i) l0[i] = l1[i] = K::filler();
  // The mask bytes of this thread's rows 8 j + 2 (lane % 4) + {0, 1} of the
  // sub-tile, loaded with its first chunk; 1 where set, 0 past the bank.
  // Over int8 also their scales (0 past the bank).
  unsigned short mb[8];
  float2 es[Op::SCALED ? 8 : 1];

  for (int s = 0; s < steps; ++s) {
    const int kc = s % kc_n, slot = s % STAGES;
    const int sub = (s / kc_n) * RB;
    if (!DOTS && kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tile_base + sub + 8 * j + 2 * (lane & 3);
        mb[j] = r + 1 < n ? *reinterpret_cast<const unsigned short*>(mask + r)
                          : (r < n ? mask[r] : 0);
        if constexpr (Op::SCALED)
          es[j] = r + 1 < n ? *reinterpret_cast<const float2*>(e_scale + r)
                            : make_float2(r < n ? e_scale[r] : 0.0f, 0.0f);
      }
    }
    tc_mma::mbar_wait(full + 8 * slot, (s / STAGES) & 1);
    const uint32_t a0 = q_addr + kc * (TQB * 128) + wg * (64 * 128);
    const uint32_t b0 = ring_addr + slot * CHUNK;
    if (kc == 0) tc_mma::wg_fence();  // the epilogue touched acc
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      tc_mma::wgmma_64x64(acc, tc_mma::desc_sw128(a0 + 32 * ks),
                          tc_mma::desc_sw128(b0 + 32 * ks), kc != 0 || ks != 0);
    tc_mma::wg_commit();
    // A sub-tile's chunks chain on the tensor cores: wait only for the
    // previous chunk's products, and release its slot; after the last
    // chunk, wait for all and release this one.
    if (kc > 0) {
      tc_mma::wg_wait<1>();
      __syncwarp();
      if (lane == 0) tc_mma::mbar_arrive(empty + 8 * ((s - 1) % STAGES));
    }
    if (kc != kc_n - 1) continue;
    tc_mma::wg_wait<0>();
    tc_mma::wg_fence_operands(acc);
    __syncwarp();
    if (lane == 0) tc_mma::mbar_arrive(empty + 8 * slot);  // this warp is done with it

    // The epilogue of sub-tile `sub`.
    if constexpr (DOTS) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int gq = q0 + qw + 8 * ((x >> 1) & 1);
        const int r = sub + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
        if (gq < b && r < rows_here) out_v[(size_t)gq * n + tile_base + r] = acc[x];
      }
      continue;
    }
    if (KC == 0) {
      t0 = lists[qw * k + k - 1];
      t1 = lists[(qw + 8) * k + k - 1];
    }
    if constexpr (WIDE) {
      // The value words of this thread's 16 rows for each of its two
      // queries, and which reach the filters' words; of those, the keys
      // that beat the filters join the lists or the buffers.
      int w0[16], w1[16];
      unsigned pass0 = 0, pass1 = 0;
      const int tw0 = (int)(t0 >> 32), tw1 = (int)(t1 >> 32);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int j = x >> 1, c = x & 1;
        const int r = sub + 8 * j + 2 * (lane & 3) + c;
        const bool valid = ((mb[j] >> (8 * c)) & 0xFF) != 0;
        const float esc = c ? es[j].y : es[j].x;
        w0[x] = policy.word(acc[4 * j + c], qs0, esc);
        w1[x] = policy.word(acc[4 * j + 2 + c], qs1, esc);
        if (r < rows_here && valid) {
          pass0 |= (unsigned)(w0[x] >= tw0) << x;
          pass1 |= (unsigned)(w1[x] >= tw1) << x;
        }
      }
      const int rl = sub + 2 * (lane & 3);  // the row of x: rl + 8 (x / 2) + x % 2
      while (pass0) {
        const int x = __ffs(pass0) - 1;
        pass0 &= pass0 - 1;
        const Key key = K::key(pick16(w0, x), rl + 8 * (x >> 1) + (x & 1));
        if (!(key > t0)) continue;
        if (KC > 0) reg_insert(l0, key);
        else cand[qw * RB + atomicAdd(cnt + qw, 1)] = key;
      }
      while (pass1) {
        const int x = __ffs(pass1) - 1;
        pass1 &= pass1 - 1;
        const Key key = K::key(pick16(w1, x), rl + 8 * (x >> 1) + (x & 1));
        if (!(key > t1)) continue;
        if (KC > 0) reg_insert(l1, key);
        else cand[(qw + 8) * RB + atomicAdd(cnt + qw + 8, 1)] = key;
      }
    } else {
      // The keys of this thread's 16 rows for each of its two queries, and
      // which beat the filters.  Only this short loop indexes acc, so it
      // unrolls and acc stays in registers.
      int key0[16], key1[16];
      unsigned pass0 = 0, pass1 = 0;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int j = x >> 1, c = x & 1;
        const int r = sub + 8 * j + 2 * (lane & 3) + c;
        const bool valid = ((mb[j] >> (8 * c)) & 0xFF) != 0;
        if constexpr (Op::SCALED) {
          const float esc = c ? es[j].y : es[j].x;
          key0[x] = policy.make(acc[4 * j + c], qs0, esc, valid, r);
          key1[x] = policy.make(acc[4 * j + 2 + c], qs1, esc, valid, r);
        } else {
          key0[x] = policy.make(acc[4 * j + c], valid, r);
          key1[x] = policy.make(acc[4 * j + 2 + c], valid, r);
        }
        if (r < rows_here) {  // past the tile: never a candidate
          pass0 |= (unsigned)(key0[x] > t0) << x;
          pass1 |= (unsigned)(key1[x] > t1) << x;
        }
      }
      while (pass0) {
        const int x = __ffs(pass0) - 1;
        pass0 &= pass0 - 1;
        const int key = pick16(key0, x);
        if (KC > 0) reg_insert(l0, key);
        else cand[qw * RB + atomicAdd(cnt + qw, 1)] = key;
      }
      while (pass1) {
        const int x = __ffs(pass1) - 1;
        pass1 &= pass1 - 1;
        const int key = pick16(key1, x);
        if (KC > 0) reg_insert(l1, key);
        else cand[(qw + 8) * RB + atomicAdd(cnt + qw + 8, 1)] = key;
      }
    }
    if (KC > 0) {
      // The next sub-tile's filters: a key must beat this thread's own
      // k-th best, and the quad's bound x, the least of its four lanes'
      // ceil(k / 4)-th best: at least k keys of the tile lie at or above x.
      t0 = max(reg_kth(l0, k), quad_min(reg_kth(l0, (k + 3) >> 2)));
      t1 = max(reg_kth(l1, k), quad_min(reg_kth(l1, (k + 3) >> 2)));
      continue;
    }
    // The warp filled its queries' buffers alone and merges them without
    // waiting for the block.
    __syncwarp();
    const int mine = lane < QPW ? cnt[warp * QPW + lane] : 0;
    unsigned busy = __ballot_sync(tile_select::FULL, mine > 0);  // one bit a query
    while (busy) {
      const int qq = warp * QPW + __ffs(busy) - 1;
      busy &= busy - 1;
      const int c = cnt[qq];
      Key* buf = cand + qq * RB;
      const Key x0 = lane < c ? buf[lane] : K::filler();
      const Key x1 = lane + 32 < c ? buf[lane + 32] : K::filler();
      __syncwarp();  // buf is the merge's scratch
      tile_select::merge_pair(lists + qq * k, k, x0, x1, K::filler(), buf, lane);
    }
    __syncwarp();
    if (lane < QPW) cnt[warp * QPW + lane] = 0;
    __syncwarp();
  }
  if constexpr (DOTS) return;
  if (KC > 0) {
    // The four lists of each query (one per lane of its quad) into cand,
    // then each query's first k of their 64 keys.
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      cand[qw * RB + (lane & 3) * NL + i] = l0[i];
      cand[(qw + 8) * RB + (lane & 3) * NL + i] = l1[i];
    }
    __syncwarp();
  }
  for (int qq = warp * QPW; qq < (warp + 1) * QPW; ++qq) {
    const int gq = q0 + qq;
    if (gq >= b) break;
    if (KC > 0) {
      // 4 NL keys a query: past them (NL < 16), fillers.
      Key x0 = cand[qq * RB + lane];
      Key x1 = 32 + lane < 4 * NL ? cand[qq * RB + 32 + lane] : K::filler();
      tile_select::sort64_desc(x0, x1, lane);
      if (lane < k) {
        const size_t o = ((size_t)gq * tiles + tile) * k + lane;
        policy.decode(x0, tile_base, out_v + o, out_i + o);
      }
      continue;
    }
    const Key* L = lists + qq * k;
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)gq * tiles + tile) * k + j;
      policy.decode(L[j], tile_base, out_v + o, out_i + o);
    }
  }
}

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

template <int TQB, int KC, typename Op, typename K, bool DOTS>
int launch_kernel(const K policy, const CUtensorMap& emap, const Args& a, size_t smem) {
  auto kernel = tc_tile_topk_kernel<TQB, KC, Op, K, DOTS>;
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

template <int TQB, typename Op, typename K, bool DOTS>
int launch_k(const K policy, const CUtensorMap& emap, const Args& a) {
  constexpr int CAP = list_cap<TQB, K>();
  const size_t smem = smem_bytes(TQB, a.d, Op::BYTES, a.k, sizeof(typename K::Key));
  if (a.k <= CAP) return launch_kernel<TQB, CAP, Op, K, DOTS>(policy, emap, a, smem);
  return launch_kernel<TQB, 0, Op, K, DOTS>(policy, emap, a, smem);
}

// Check the operands and launch the kernel with the widest query block that
// fits.  `max_tile` is 2048 for B1, B3e and B5 (an 11-bit lane field; B3e
// keeps B1's tiles) and 8192 for B7i and B7f.
template <typename Op, typename K, bool DOTS>
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
  const size_t key_bytes = sizeof(typename K::Key);
  const bool only_64 = list_cap<128, K>() < a.k && a.k <= KCAP;
  if (!only_64 && smem_bytes(128, a.d, Op::BYTES, a.k, key_bytes) <= MAX_SMEM)
    return launch_k<128, Op, K, DOTS>(policy, emap, a);
  if (smem_bytes(64, a.d, Op::BYTES, a.k, key_bytes) <= MAX_SMEM)
    return launch_k<64, Op, K, DOTS>(policy, emap, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc_tile
