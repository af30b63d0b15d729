// float_tile_topk — kernels B4, B5 and B7f of the port: float cosine scores
// and the top-k of every index tile (B4, B5) or supertile (B7f), over an f32
// or a bf16 bank.
//
// B4, `float_tile_topk`, replaces `_topk_tile_kernel`
// (hcrag_tpu/ops/topk_pallas.py), launched by
// `pallas_cosine_top_k(packed_select=False)`: the exact kernel of the float
// parity contract.  For query b and the rows n of tile t with mask[n] set,
// s = dot(q[b], e[n]), and the tile keeps its k best valid rows by
// (s descending, row ascending), with the raw f32 value.  When fewer than k
// valid rows remain, every further slot is (-1e30, t * tile_n): the TPU
// kernel adds -1e30 to masked rows and removes each pick by writing -1e30
// over it, so once the valid rows are gone all its columns tie at -1e30 and
// every first-occurrence argmax pass returns the tile's first row.  No slot
// is ever (-1e30, -1).  The order is a unique 64-bit word: the f32 bits
// mapped to an order-preserving int32 (bits ^ ((bits >> 31) & 0x7FFFFFFF))
// in the high half and 0xFFFFFFFF - row_in_tile in the low half, so a plain
// signed max gives value descending with ties to the lowest row.  Adding 0.0
// turns a -0.0 dot into +0.0, so the two zeros tie as they do in the TPU
// kernel's compares.
//
// B5, `float_packed_tile_topk`, replaces `_topk_tile_kernel_packed`
// (topk_pallas.py), launched by `pallas_cosine_top_k(packed_select=True)`,
// in its exhaustive branch (two_level=False): kernel B1's contract over a
// float dot,
//
//   s   = dot(q[b], e[n]) + (mask[n] ? 2.0 : -3.0)
//   key = (bits(s) & ~0x7FF) | (2047 - (n - t * tile_n))      as int32
//
// with the k largest keys decoding to val = float(key & ~0x7FF) - 2.0 and
// idx = t * tile_n + 2047 - (key & 0x7FF); a key <= 0 (masked row, row past
// n, no row left) decodes to the filler (-1e30, -1).  The shifts use
// __fadd_rn (and the build passes --fmad=false).
//
// B7f, `float_packed_super_tile_topk`, replaces
// `_topk_tile_kernel_packed_super` (topk_pallas.py), launched by
// `pallas_cosine_top_k(super_tiles > 1)`: B5's contract over a supertile of
// lbits = spt * tile_n rows (a power of two from 128 to 8192) with a lane
// field that wide, key = (bits(s) & ~(lbits - 1)) | (lbits - 1 - r) for row r
// of supertile t, decoding to idx = t * lbits + lbits - 1 - (key & (lbits - 1)).
// The TPU kernel keeps T candidates per 128-row lane and can drop a row that
// shares its lane with T better ones; this kernel keeps the exact top k_sub.
// It is B5's kernel with the supertile as its tile and this key policy.  At
// the supertile path S1 (B = 8192 over 1,007,616 bf16 rows) it does B5's
// 6.3e12 operations (6.4 ms at the bf16 tensor-core rate), bound by
// operations.
//
// The dot.  Over an f32 bank (and for B4 over either type) the products are
// full f32 FMAs on the CUDA cores, accumulated with __fmaf_rn in index
// order (float_dot.cuh; bf16 values are widened to f32, where their
// products are exact): no TF32, as the TPU kernel pins Precision.HIGHEST.
// B5 and B7f over a bf16 bank (the caller passes bf16 queries, as the TPU
// kernel casts the query to the bank's type) run on the bf16 tensor cores
// with f32 sums (bf16_mma.cuh), which add in their own order: their keys
// equal the plain version's on exact dots and agree to rounding elsewhere
// (testing.py states how far).
//
// What bounds it on an H100: at path F1 (B4: B = 1024 queries, N = 1,001,472
// rows, D = 384, f32) it does 2*B*N*D = 0.79e12 f32 operations, 11.8 ms at
// the 67 TFLOP/s of the CUDA cores, against 1.54 GB of bank (0.46 ms at
// 3.35 TB/s); at path F2 (B5: B = 8192, bf16 bank) 6.3e12 operations, 6.4 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against a 0.77 GB bank.  Both
// are bound by operations.  The tensor-core kernel below brings B5 and B7f
// within about 10x of that bound; what keeps them there is in PERF.md.
//
// Design of the CUDA-core kernel (as B1's): one block takes QB = 64 queries
// and one tile.  The query block stays in shared memory as f32; the tile
// streams through shared memory in sub-tiles of RB = 64 rows and chunks of
// DC = 64 columns.  256 threads each compute a 4 x 4 block of dots with
// 16-byte shared loads (the dot loop of float_dot.cuh, which B8 shares),
// write the keys to shared memory, and each warp merges the keys of its 8
// queries into their sorted lists (tile_select.cuh).  Both kernels order
// their blocks query block fastest, so all query blocks of one tile run
// together and read the tile from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "float_dot.cuh"
#include "tile_select.cuh"

namespace {

using float_dot::DC;
using float_dot::E_STRIDE;
using float_dot::QB;
using float_dot::RB;
using float_dot::THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QB / WARPS;
constexpr int KEY_STRIDE = 68;  // keys per query row of the key buffer
constexpr int MAX_K = tile_select::MAX_K;
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

// B4's key: order-preserving score bits | ~row.  Masked rows never enter
// the list; its empty slots decode to the tile's -1e30 fill.
struct ExactKey {
  using Key = long long;
  __device__ static Key filler() { return LLONG_MIN; }
  __device__ static Key make(float dot, bool valid, int row) {
    if (!valid) return LLONG_MIN;
    const int bits = __float_as_int(__fadd_rn(dot, 0.0f));
    const unsigned skey = (unsigned)(bits ^ ((bits >> 31) & 0x7FFFFFFF));
    return (long long)(((unsigned long long)skey << 32) |
                       (unsigned long long)(0xFFFFFFFFu - (unsigned)row));
  }
  __device__ static void decode(Key key, int tile_base, float* v, int* i) {
    if (key == LLONG_MIN) {
      *v = -1e30f;
      *i = tile_base;
      return;
    }
    const int skey = (int)(key >> 32);
    *v = __int_as_float(skey ^ ((skey >> 31) & 0x7FFFFFFF));
    *i = tile_base + (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFll));
  }
};

// B5's key: B1's packed (score + 2 | 2047 - lane) int32.
struct PackedKey {
  using Key = int;
  __device__ static Key filler() { return 0; }
  __device__ static Key make(float dot, bool valid, int row) {
    const float s = __fadd_rn(dot, valid ? 2.0f : -3.0f);
    return (__float_as_int(s) & ~0x7FF) | (2047 - row);
  }
  __device__ static void decode(Key key, int tile_base, float* v, int* i) {
    if (key > 0) {
      *v = __fsub_rn(__int_as_float(key & ~0x7FF), 2.0f);
      *i = tile_base + 2047 - (key & 0x7FF);
    } else {
      *v = -1e30f;
      *i = -1;
    }
  }
};

// B7f's key: B5's packed key with an lbits-wide lane field; `lmask` is
// lbits - 1.
struct SuperKey {
  using Key = int;
  int lmask;
  __device__ static Key filler() { return 0; }
  __device__ Key make(float dot, bool valid, int row) const {
    const float s = __fadd_rn(dot, valid ? 2.0f : -3.0f);
    return (__float_as_int(s) & ~lmask) | (lmask - row);
  }
  __device__ void decode(Key key, int tile_base, float* v, int* i) const {
    if (key > 0) {
      *v = __fsub_rn(__int_as_float(key & ~lmask), 2.0f);
      *i = tile_base + lmask - (key & lmask);
    } else {
      *v = -1e30f;
      *i = -1;
    }
  }
};

size_t smem_bytes(int d, int k, size_t key_bytes) {
  return sizeof(float) * float_dot::smem_floats(d) +
         key_bytes * (size_t)QB * (KEY_STRIDE + k) + sizeof(int) * RB;
}

template <typename T, typename K>
__global__ void __launch_bounds__(THREADS)
float_tile_topk_kernel(const T* __restrict__ q, const T* __restrict__ e,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int b, int n, int d, int k, int tile_n, int tiles,
                       const K policy) {
  using Key = typename K::Key;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_stride = d + 4;  // padded rows spread the shared banks
  float* q_rows = reinterpret_cast<float*>(smem);
  float* e_rows = q_rows + QB * q_stride;  // float_dot's layout
  Key* keys = reinterpret_cast<Key*>(e_rows + RB * E_STRIDE);
  Key* lists = keys + QB * KEY_STRIDE;
  int* valid_s = reinterpret_cast<int*>(lists + QB * k);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tq = tid >> 4;  // queries tq*4 .. tq*4+3
  const int tr = tid & 15;  // rows tr, tr+16, tr+32, tr+48 of the sub-tile
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int tile_base = tile * tile_n;
  const int rows_here = min(tile_n, n - tile_base);

  float_dot::stage_queries(q, q_rows, q0, b, d);
  for (int x = tid; x < QB * k; x += THREADS) lists[x] = K::filler();

  for (int sub = 0; sub < rows_here; sub += RB) {
    float acc[4][4];
    float_dot::sub_tile_dots(e, q_rows, e_rows, d, tile_base, sub, rows_here, acc,
                             [&](int dc) {
                               if (dc == 0 && tid < RB) {
                                 const bool in = sub + tid < rows_here;
                                 valid_s[tid] = in ? (mask[tile_base + sub + tid] != 0) : -1;
                               }
                             });

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * j;
        const int vs = valid_s[r];
        // Rows past the tile's end never enter a list.
        keys[(tq * 4 + i) * KEY_STRIDE + r] =
            vs < 0 ? K::filler() : policy.make(acc[i][j], vs != 0, sub + r);
      }
    __syncthreads();

    for (int qq = warp * Q_PER_WARP; qq < (warp + 1) * Q_PER_WARP; ++qq)
      tile_select::merge_64(keys + qq * KEY_STRIDE, lists + qq * k, k, lane);
  }

  for (int qq = warp * Q_PER_WARP; qq < (warp + 1) * Q_PER_WARP; ++qq) {
    const int gq = q0 + qq;
    if (gq >= b) break;
    const Key* L = lists + qq * k;
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)gq * tiles + tile) * k + j;
      policy.decode(L[j], tile_base, out_v + o, out_i + o);
    }
  }
}

// B5 and B7f over a bf16 bank: the dots on the tensor cores (bf16_mma.cuh),
// the selection in their epilogue.
//
// A block takes TQB queries (128, or 64 where 128 do not fit shared memory)
// and one tile, with two consumer warpgroups (one for TQB = 64) and a
// producer warp.  The queries stay in shared memory as bf16 for the whole
// tile; the tile streams through a ring of STAGES chunks of 64 rows x 64
// columns: the producer keeps STAGES TMA copies in flight, each completing
// on its slot's `full` mbarrier (the TMA fills rows past the bank with
// zeros), and refills a slot once all consumer warps have arrived on its
// `empty` mbarrier, so the warpgroups never wait for each other.
// Warpgroup g sums queries 64 g .. + 63 with the 64 rows of each sub-tile
// by wgmma (m64n64k16, both operands from shared memory, f32 sums in
// registers), four per chunk, a sub-tile's chunks chained on the tensor
// cores; each warp so holds all 64 sums of 16 queries, and loads the mask
// bytes of its rows with the sub-tile's first chunk.  After a sub-tile's
// last chunk each thread builds its keys with
// the policy's `make` and keeps only those above its query's running k-th
// best key for this tile:
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
// DOTS writes the raw sums to out_v ([b, n]) instead: the loop's own
// numbers, for measuring its error.
constexpr int TC_RB = 64;      // rows per sub-tile
constexpr int TC_STAGES = 4;   // chunks in the ring
constexpr int TC_CHUNK = TC_RB * 128;  // bytes of one 64 x 64 bf16 chunk
constexpr int TC_KCAP = 16;    // the register lists' length

// Shared memory, with 1024 bytes to align the operands to the swizzle's
// 1024-byte atoms.
size_t tc_smem_bytes(int qb, int d, int k) {
  return 1024 + (size_t)qb * d * 2 + (size_t)TC_STAGES * (TC_CHUNK + 16) +
         sizeof(int) * ((size_t)qb * TC_RB + (size_t)qb * k + qb);
}

// Insert x into the descending register list v (its last entry below x).
template <int N>
__device__ __forceinline__ void reg_insert(int (&v)[N], int x) {
#pragma unroll
  for (int i = N - 1; i > 0; --i) v[i] = v[i - 1] < x ? v[i - 1] : (v[i] < x ? x : v[i]);
  v[0] = v[0] < x ? x : v[0];
}

template <int N>
__device__ __forceinline__ int reg_kth(const int (&v)[N], int k) {
  int t = v[0];
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

template <int TQB, int KCAP, typename K, bool DOTS>
__global__ void __launch_bounds__(TQB * 2 + 32)
tc_tile_topk_kernel(const __grid_constant__ CUtensorMap emap,
                    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ mask,
                    float* __restrict__ out_v, int* __restrict__ out_i, int b, int n, int d,
                    int k, int tile_n, int tiles, const K policy) {
  constexpr int NT = TQB * 2;    // the consumer warpgroups' threads
  constexpr int NW = NT / 32;
  constexpr int QPW = TQB / NW;  // queries each warp holds and merges: 16
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* q_s =                                // d / 64 chunks of TQB rows
      smem_raw + ((1024 - (bf16_mma::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + (size_t)TQB * d * 2;    // TC_STAGES chunks of 64 rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + TC_STAGES * TC_CHUNK);  // full, empty
  int* cand = reinterpret_cast<int*>(bars + 2 * TC_STAGES);  // [TQB][TC_RB]
  int* lists = cand + TQB * TC_RB;                    // [TQB][k], sorted descending
  int* cnt = lists + TQB * k;                         // [TQB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int tile_base = tile * tile_n;
  const int rows_here = min(tile_n, n - tile_base);
  const int kc_n = d / 64;
  const int steps = (rows_here + TC_RB - 1) / TC_RB * kc_n;
  const uint32_t ring_addr = bf16_mma::smem_addr(ring);
  const uint32_t full = bf16_mma::smem_addr(bars);  // + 8 slot: chunk landed
  const uint32_t empty = full + 8 * TC_STAGES;      // + 8 slot: every warp is done with it

  if (tid == 0) {
    for (int x = 0; x < TC_STAGES; ++x) {
      bf16_mma::mbar_init(full + 8 * x, 1);
      bf16_mma::mbar_init(empty + 8 * x, NW);
    }
    bf16_mma::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NW) {
    // The producer warp: lane 0 keeps STAGES chunks in flight, chunk s
    // (chunk s % kc_n of sub-tile s / kc_n) into slot s % STAGES once every
    // consumer warp has released the slot's previous chunk.
    if (lane == 0)
      for (int s = 0; s < steps; ++s) {
        const int slot = s % TC_STAGES;
        if (s >= TC_STAGES) bf16_mma::mbar_wait(empty + 8 * slot, (s / TC_STAGES - 1) & 1);
        bf16_mma::mbar_expect(full + 8 * slot, TC_CHUNK);
        bf16_mma::tma_2d(ring_addr + slot * TC_CHUNK, &emap, (s % kc_n) * 64,
                         tile_base + (s / kc_n) * TC_RB, full + 8 * slot);
      }
    return;
  }

  // The consumers: two warpgroups (one for TQB = 64).
  const int wg = warp >> 2;  // warpgroup: queries 64 wg .. 64 wg + 63
  const int qw = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and + 8: this thread's
  const int q0 = blockIdx.x * TQB;
  const uint32_t q_addr = bf16_mma::smem_addr(q_s);
  // The query block, rows past b as zeros.
  for (int x = tid; x < TQB * (d / 8); x += NT) {
    const int r = x / (d / 8), seg = x - r * (d / 8);
    const bool in = q0 + r < b;
    bf16_mma::cp16(q_addr + (seg >> 3) * (TQB * 128) + bf16_mma::swz(r, (seg & 7) * 8),
                   in ? (const void*)(q + (size_t)(q0 + r) * d + seg * 8) : (const void*)q,
                   in ? 16 : 0);
  }
  bf16_mma::cp_commit();
  if (!DOTS && KCAP == 0) {
    for (int x = tid; x < TQB * k; x += NT) lists[x] = K::filler();
    for (int x = tid; x < TQB; x += NT) cnt[x] = 0;
  }
  bf16_mma::cp_wait<0>();
  bf16_mma::fence_async_smem();
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // the consumers only

  // acc[4 j + 2 h + c]: query qw + 8 h, row 8 j + 2 (lane % 4) + c of the
  // sub-tile (bf16_mma::wgmma_64x64).
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.0f;
  constexpr int NL = KCAP > 0 ? KCAP : 1;
  int l0[NL], l1[NL];  // KCAP: this thread's lists of its two queries
  int t0 = K::filler(), t1 = K::filler();  // and their filters
#pragma unroll
  for (int i = 0; i < NL; ++i) l0[i] = l1[i] = K::filler();
  // The mask bytes of this thread's rows 8 j + 2 (lane % 4) + {0, 1} of the
  // sub-tile, loaded with its first chunk; 1 where set, 0 past the bank.
  unsigned short mb[8];

  for (int s = 0; s < steps; ++s) {
    const int kc = s % kc_n, slot = s % TC_STAGES;
    const int sub = (s / kc_n) * TC_RB;
    if (!DOTS && kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tile_base + sub + 8 * j + 2 * (lane & 3);
        mb[j] = r + 1 < n ? *reinterpret_cast<const unsigned short*>(mask + r)
                          : (r < n ? mask[r] : 0);
      }
    }
    bf16_mma::mbar_wait(full + 8 * slot, (s / TC_STAGES) & 1);
    const uint32_t a0 = q_addr + kc * (TQB * 128) + wg * (64 * 128);
    const uint32_t b0 = ring_addr + slot * TC_CHUNK;
    if (kc == 0) bf16_mma::wg_fence();  // the epilogue touched acc
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      bf16_mma::wgmma_64x64(acc, bf16_mma::desc_sw128(a0 + 32 * ks),
                            bf16_mma::desc_sw128(b0 + 32 * ks), kc != 0 || ks != 0);
    bf16_mma::wg_commit();
    // A sub-tile's chunks chain on the tensor cores: wait only for the
    // previous chunk's products, and release its slot; after the last
    // chunk, wait for all and release this one.
    if (kc > 0) {
      bf16_mma::wg_wait<1>();
      __syncwarp();
      if (lane == 0) bf16_mma::mbar_arrive(empty + 8 * ((s - 1) % TC_STAGES));
    }
    if (kc != kc_n - 1) continue;
    bf16_mma::wg_wait<0>();
    bf16_mma::wg_fence_operands(acc);
    __syncwarp();
    if (lane == 0) bf16_mma::mbar_arrive(empty + 8 * slot);  // this warp is done with it

    // The epilogue of sub-tile `sub`.
    if (DOTS) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int gq = q0 + qw + 8 * ((x >> 1) & 1);
        const int r = sub + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
        if (gq < b && r < rows_here) out_v[(size_t)gq * n + tile_base + r] = acc[x];
      }
      continue;
    }
    if (KCAP == 0) {
      t0 = lists[qw * k + k - 1];
      t1 = lists[(qw + 8) * k + k - 1];
    }
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
      key0[x] = policy.make(acc[4 * j + c], valid, r);
      key1[x] = policy.make(acc[4 * j + 2 + c], valid, r);
      if (r < rows_here) {  // past the tile: never a candidate
        pass0 |= (unsigned)(key0[x] > t0) << x;
        pass1 |= (unsigned)(key1[x] > t1) << x;
      }
    }
    while (pass0) {
      const int x = __ffs(pass0) - 1;
      pass0 &= pass0 - 1;
      const int key = pick16(key0, x);
      if (KCAP > 0) reg_insert(l0, key);
      else cand[qw * TC_RB + atomicAdd(cnt + qw, 1)] = key;
    }
    while (pass1) {
      const int x = __ffs(pass1) - 1;
      pass1 &= pass1 - 1;
      const int key = pick16(key1, x);
      if (KCAP > 0) reg_insert(l1, key);
      else cand[(qw + 8) * TC_RB + atomicAdd(cnt + qw + 8, 1)] = key;
    }
    if (KCAP > 0) {
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
      int* buf = cand + qq * TC_RB;
      const int x0 = lane < c ? buf[lane] : K::filler();
      const int x1 = lane + 32 < c ? buf[lane + 32] : K::filler();
      __syncwarp();  // buf is the merge's scratch
      tile_select::merge_pair(lists + qq * k, k, x0, x1, K::filler(), buf, lane);
    }
    __syncwarp();
    if (lane < QPW) cnt[warp * QPW + lane] = 0;
    __syncwarp();
  }
  if (DOTS) return;
  if (KCAP > 0) {
    // The four lists of each query (one per lane of its quad) into cand,
    // then each query's first k of their 64 keys.
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      cand[qw * TC_RB + (lane & 3) * NL + i] = l0[i];
      cand[(qw + 8) * TC_RB + (lane & 3) * NL + i] = l1[i];
    }
    __syncwarp();
  }
  for (int qq = warp * QPW; qq < (warp + 1) * QPW; ++qq) {
    const int gq = q0 + qq;
    if (gq >= b) break;
    if (KCAP > 0) {
      int x0 = cand[qq * TC_RB + lane], x1 = cand[qq * TC_RB + 32 + lane];
      tile_select::sort64_desc(x0, x1, lane);
      if (lane < k) {
        const size_t o = ((size_t)gq * tiles + tile) * k + lane;
        policy.decode(x0, tile_base, out_v + o, out_i + o);
      }
      continue;
    }
    const int* L = lists + qq * k;
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

// The tensor map of the bank: 64 x 64 boxes, 128-byte swizzle; rows past
// the bank read as zeros.
int tc_map(const void* e, int n, int d, CUtensorMap* emap) {
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
  const cuuint64_t stride[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, TC_RB};
  const cuuint32_t one[2] = {1, 1};
  if (encode(emap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(e), dims, stride,
             box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int TQB, int KCAP, typename K, bool DOTS>
int tc_launch(const K policy, const CUtensorMap& emap, const void* q, const void* mask,
              void* out_v, void* out_i, int b, int n, int d, int k, int tile_n, int tiles,
              size_t smem, void* stream) {
  auto kernel = tc_tile_topk_kernel<TQB, KCAP, K, DOTS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + TQB - 1) / TQB, tiles);
  kernel<<<grid, TQB * 2 + 32, smem, (cudaStream_t)stream>>>(
      emap, (const __nv_bfloat16*)q, (const uint8_t*)mask, (float*)out_v, (int*)out_i, b, n,
      d, k, tile_n, tiles, policy);
  return (int)cudaGetLastError();
}

template <int TQB, typename K, bool DOTS>
int tc_launch_k(const K policy, const CUtensorMap& emap, const void* q, const void* mask,
                void* out_v, void* out_i, int b, int n, int d, int k, int tile_n, int tiles,
                void* stream) {
  const size_t smem = tc_smem_bytes(TQB, d, k);
  if (k <= TC_KCAP)
    return tc_launch<TQB, TC_KCAP, K, DOTS>(policy, emap, q, mask, out_v, out_i, b, n, d, k,
                                            tile_n, tiles, smem, stream);
  return tc_launch<TQB, 0, K, DOTS>(policy, emap, q, mask, out_v, out_i, b, n, d, k, tile_n,
                                    tiles, smem, stream);
}

// The tensor-core kernel with the widest query block that fits.
template <typename K, bool DOTS>
int tc_launch_fit(const K policy, const void* q, const void* e, const void* mask,
                  void* out_v, void* out_i, int b, int n, int d, int k, int tile_n,
                  int max_tile, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % 64 != 0 || k < 1 || k > MAX_K || k > tile_n ||
      tile_n % TC_RB != 0 || tile_n > max_tile || (size_t)e % 16 != 0 ||
      (size_t)mask % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile_n - 1) / tile_n;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap emap;
  const int err = tc_map(e, n, d, &emap);
  if (err) return err;
  if (tc_smem_bytes(128, d, k) <= MAX_SMEM)
    return tc_launch_k<128, K, DOTS>(policy, emap, q, mask, out_v, out_i, b, n, d, k, tile_n,
                                     tiles, stream);
  if (tc_smem_bytes(64, d, k) <= MAX_SMEM)
    return tc_launch_k<64, K, DOTS>(policy, emap, q, mask, out_v, out_i, b, n, d, k, tile_n,
                                    tiles, stream);
  return (int)cudaErrorInvalidValue;
}

// `max_tile` is 2048 for B4 and B5 (B5's lane field has 11 bits; B4 keeps
// the same tiles) and 8192 for B7f.
template <typename T, typename K>
int launch(const K policy, const void* q, const void* e, const void* mask,
           void* out_v, void* out_i, int b, int n, int d, int k, int tile_n,
           int max_tile, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % DC != 0 || k < 1 || k > MAX_K ||
      k > tile_n || tile_n % RB != 0 || tile_n > max_tile)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile_n - 1) / tile_n;
  const size_t smem = smem_bytes(d, k, sizeof(typename K::Key));
  if (tiles > 65535 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      float_tile_topk_kernel<T, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QB - 1) / QB, tiles);
  float_tile_topk_kernel<T, K><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)e, (const uint8_t*)mask, (float*)out_v,
      (int*)out_i, b, n, d, k, tile_n, tiles, policy);
  return (int)cudaGetLastError();
}

// B4 (ExactKey) and every f32 bank take the CUDA-core loop; the packed
// policies over a bf16 bank take the tensor cores.
template <typename K>
int launch_typed(const K policy, const void* q, const void* e,
                 const void* mask, void* out_v, void* out_i, int b, int n,
                 int d, int k, int tile_n, int max_tile, int bf16,
                 void* stream) {
  return bf16 ? launch<__nv_bfloat16>(policy, q, e, mask, out_v, out_i, b, n,
                                      d, k, tile_n, max_tile, stream)
              : launch<float>(policy, q, e, mask, out_v, out_i, b, n, d, k,
                              tile_n, max_tile, stream);
}

template <typename K>
int launch_packed(const K policy, const void* q, const void* e, const void* mask,
                  void* out_v, void* out_i, int b, int n, int d, int k, int tile_n,
                  int max_tile, int bf16, void* stream) {
  if (bf16)
    return tc_launch_fit<K, false>(policy, q, e, mask, out_v, out_i, b, n, d, k, tile_n,
                                   max_tile, stream);
  return launch<float>(policy, q, e, mask, out_v, out_i, b, n, d, k, tile_n, max_tile,
                       stream);
}

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers:
//   q [b, d] and e [n, d], both f32 (bf16 == 0) or both bf16 (bf16 != 0),
//   mask [n] bool (one byte each), out_v [b, tiles, k] f32,
//   out_i [b, tiles, k] int32, with tiles = ceil(n / tile_n) (B7f: the
//   supertiles, ceil(n / lbits)).
// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int float_tile_topk(const void* q, const void* e, const void* mask,
                               void* out_v, void* out_i, int b, int n, int d,
                               int k, int tile_n, int bf16, void* stream) {
  return launch_typed(ExactKey{}, q, e, mask, out_v, out_i, b, n, d, k, tile_n,
                      2048, bf16, stream);
}

extern "C" int float_packed_tile_topk(const void* q, const void* e,
                                      const void* mask, void* out_v,
                                      void* out_i, int b, int n, int d, int k,
                                      int tile_n, int bf16, void* stream) {
  return launch_packed(PackedKey{}, q, e, mask, out_v, out_i, b, n, d, k,
                       tile_n, 2048, bf16, stream);
}

extern "C" int float_packed_super_tile_topk(const void* q, const void* e,
                                            const void* mask, void* out_v,
                                            void* out_i, int b, int n, int d,
                                            int k, int lbits, int bf16,
                                            void* stream) {
  if (lbits < 128 || (lbits & (lbits - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  return launch_packed(SuperKey{lbits - 1}, q, e, mask, out_v, out_i, b, n, d,
                       k, lbits, 8192, bf16, stream);
}

// The sums of the tensor-core loop of B5 / B7f alone: out [b, n] f32 with
// out[i, r] = dot(q[i], e[r]) for bf16 q [b, d] and e [n, d], taken as the
// kernels take them (for measuring the loop's error, not on a query path).
extern "C" int bf16_tc_dots(const void* q, const void* e, void* out, int b, int n, int d,
                            void* stream) {
  return tc_launch_fit<PackedKey, true>(PackedKey{}, q, e, nullptr, out, nullptr, b, n, d,
                                        1, 2048, 2048, stream);
}
