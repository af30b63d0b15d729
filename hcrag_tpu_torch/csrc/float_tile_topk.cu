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
// The dot.  Over an f32 bank the products are full f32 FMAs on the CUDA
// cores, accumulated with __fmaf_rn in index order (float_dot.cuh): no
// TF32, as the TPU kernel pins Precision.HIGHEST.  Over a bf16 bank (the
// caller passes bf16 queries, as the TPU kernel casts the query to the
// bank's type) B4, B5 and B7f run on the bf16 tensor cores with f32 sums
// (tc_tile_topk.cuh): bf16 x bf16 products are exact in f32, and the sums
// stay f32 but add in the tensor cores' own order, within
// testing.TC_DOT_ERROR of the float64 dots.  Their keys equal the plain
// version's on exact dots and agree to rounding elsewhere (testing.py
// states how far).  B4 over bf16 takes the CUDA-core loop where the tensor
// cores would run 64-query blocks with shared-memory buffers (k = 100 at
// d = 384, slower there on an H100), or where no plan fits.
//
// What bounds it on an H100: at path F1 (B4: B = 1024 queries, N = 1,001,472
// rows, D = 384, f32) it does 2*B*N*D = 0.79e12 f32 operations, 11.8 ms at
// the 67 TFLOP/s of the CUDA cores, against 1.54 GB of bank (0.46 ms at
// 3.35 TB/s); over the same bank in bf16 (B4 in kg1m_bf16.batch1k) the same
// operations take 0.80 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// a 0.77 GB bank; at path F2 (B5: B = 8192, bf16 bank) 6.3e12 operations,
// 6.4 ms.  All are bound by operations.  The tensor-core kernel
// (tc_tile_topk.cuh, which B1, B3e and B7i share) brings B5 and B7f within
// about 6x of that bound, and B4 over bf16 with its 64-bit key within about
// 7x (5.7 ms against 0.80 at kg1m_bf16.batch1k's shape on an H100 at 700 W);
// what keeps them there, the selection epilogue, is in PERF.md.
//
// Design of the CUDA-core kernel (B4, B5 and B7f over an f32 bank, B4 over
// a bf16 bank where the tensor cores do not take it): one block takes
// QB = 128 queries and one tile, and runs the register-tiled loop of
// float_dot.cuh (which B8 shares) over the tile's 128-row sub-tiles.  The
// selection is a filtering epilogue, not a merge of every key: after each
// sub-tile each thread holds the 8 x 8 sums of its 8 queries and 8 rows,
// and compares them, half a sub-tile (64 rows) at a time, against each
// query's current k-th best key of the tile, read from the query's sorted
// list in shared memory.  For B4's 64-bit key it
// compares the 32-bit order-preserving value word first, and builds the
// 64-bit key (word << 32 | ~row) only where the word reaches the k-th
// one's (an equal word with a lower row still gets in).  Survivors go to
// the query's candidate buffer (64 slots, by a shared atomicAdd).  After a
// barrier the buffers are merged into the lists: up to k = 16 each lane of
// a warp inserts one query's buffer into its list, one key at a time (the
// warp's 16 queries at once); past that, where an insertion costs O(k),
// the warp merges its queries' buffers one after another
// (tile_select::merge_pair).  A second barrier publishes the new bounds.
// About k ln(tile / k) + 64 of a tile's rows reach a query's buffers; the
// buffers are laid out query-minor, so the lanes' loads fall in distinct
// banks.  Shared memory: the loop's 16.5 KB, the buffers
// (64 KB of 64-bit keys), the lists (QB x k keys) and 4 KB of merge
// scratch: 97 KB at k = 10, so two blocks share an SM, and
// 218 KB at k = 128, which still fits one.  Blocks are ordered query block
// fastest, so all query blocks of one tile run together and read the tile
// from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "float_dot.cuh"
#include "tc_tile_topk.cuh"
#include "tile_select.cuh"

namespace {

using float_dot::QB;
using float_dot::RB;
using float_dot::THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QB / WARPS;  // queries whose buffers a warp merges
constexpr int CAND = RB / 2;            // candidate slots per query: half a sub-tile
constexpr int LANE_K = 16;  // up to this k, one lane merges each query's buffer
constexpr int MAX_K = tile_select::MAX_K;
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

// B4's key: order-preserving score bits | ~row.  Masked rows never enter
// the list; its empty slots decode to the tile's -1e30 fill.  The epilogue
// compares `word` (the high half) first and builds the key only for rows
// whose word reaches the bound.
struct ExactKey {
  using Key = long long;
  __device__ static Key filler() { return LLONG_MIN; }
  __device__ static int word(float dot) {
    const int bits = __float_as_int(__fadd_rn(dot, 0.0f));
    return bits ^ ((bits >> 31) & 0x7FFFFFFF);
  }
  __device__ static Key key(int word, int row) {
    return (long long)(((unsigned long long)(unsigned)word << 32) |
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

// Shared memory of the CUDA-core kernel: the loop's chunk buffers, then the
// candidate buffers, the lists, each warp's 64 keys of merge scratch, and
// the counts.
size_t smem_bytes(int k, size_t key_bytes) {
  return float_dot::SMEM_BYTES + key_bytes * ((size_t)QB * (CAND + k) + WARPS * 64) +
         sizeof(int) * QB;
}

template <typename Key>
__device__ __forceinline__ Key pick4(const Key (&v)[4], int x) {
  return x == 0 ? v[0] : x == 1 ? v[1] : x == 2 ? v[2] : v[3];
}

template <typename T, typename K>
__global__ void __launch_bounds__(THREADS, 2)
float_tile_topk_kernel(const T* __restrict__ q, const T* __restrict__ e,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int b, int n, int d, int k, int tile_n, int tiles,
                       const K policy) {
  using Key = typename K::Key;
  constexpr bool WIDE = sizeof(Key) == 8;  // B4's key: compare the value word first
  extern __shared__ __align__(16) unsigned char smem[];
  Key* cand = reinterpret_cast<Key*>(smem + float_dot::SMEM_BYTES);  // [CAND][QB]
  Key* lists = cand + QB * CAND;                                     // [QB][k], descending
  Key* scratch = lists + QB * k;                                     // [WARPS][64]
  int* cnt = reinterpret_cast<int*>(scratch + WARPS * 64);           // [QB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = float_dot::thread_tx();
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int tile_base = tile * tile_n;
  const int rows_here = min(tile_n, n - tile_base);

  for (int x = tid; x < QB * k; x += THREADS) lists[x] = K::filler();
  for (int x = tid; x < QB; x += THREADS) cnt[x] = 0;

  float_dot::tile_dots(q, e, reinterpret_cast<float*>(smem), b, d, q0, tile_base, rows_here,
                       [&](float (&acc)[8][8], int sub) {
    // The flags of this thread's 8 rows: inside the tile, and mask set.
    unsigned inside = 0, valid = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = sub + float_dot::row_of(j);
      if (r < rows_here) {
        inside |= 1u << j;
        valid |= (unsigned)(mask[tile_base + r] != 0) << j;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 64 h .. 64 h + 63 of the sub-tile
      const int r0 = sub + 64 * h + 4 * tx;  // this thread's rows r0 .. r0 + 3
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qq = float_dot::query_of(i);
        const Key t = lists[qq * k + k - 1];
        Key key[4];
        int word[4];
        unsigned pass = 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * h + jj;
          if constexpr (WIDE) {
            word[jj] = K::word(acc[i][j]);
            pass |= (unsigned)(((valid >> j) & 1) && word[jj] >= (int)(t >> 32)) << jj;
          } else {
            key[jj] = policy.make(acc[i][j], (valid >> j) & 1, r0 + jj);
            pass |= (unsigned)(((inside >> j) & 1) && key[jj] > t) << jj;
          }
        }
        while (pass) {
          const int x = __ffs(pass) - 1;
          pass &= pass - 1;
          Key c;
          if constexpr (WIDE) {
            c = K::key(pick4(word, x), r0 + x);
            if (!(c > t)) continue;
          } else {
            c = pick4(key, x);
          }
          cand[atomicAdd(cnt + qq, 1) * QB + qq] = c;
        }
      }
      __syncthreads();
      // The merges of the warp's queries' buffers into their lists.
      if (k <= LANE_K) {
        // Lane l inserts the buffer of query 16 w + l into its list, one
        // key at a time (16 lists at once, each a lane's own).
        if (lane < Q_PER_WARP) {
          const int qq = warp * Q_PER_WARP + lane;
          Key* L = lists + qq * k;
          Key kth = L[k - 1];
          const int c = cnt[qq];
          for (int x = 0; x < c; ++x) {
            const Key key = cand[x * QB + qq];
            if (!(key > kth)) continue;
            int j = k - 1;
            for (; j > 0; --j) {
              const Key up = L[j - 1];
              if (!(up < key)) break;
              L[j] = up;
            }
            L[j] = key;
            kth = L[k - 1];
          }
          cnt[qq] = 0;
        }
      } else {
        // The warp merges the buffers of its queries that have any.
        const int mine = lane < Q_PER_WARP ? cnt[warp * Q_PER_WARP + lane] : 0;
        unsigned busy = __ballot_sync(tile_select::FULL, mine > 0);
        while (busy) {
          const int qq = warp * Q_PER_WARP + __ffs(busy) - 1;
          busy &= busy - 1;
          const int c = cnt[qq];
          const Key x0 = lane < c ? cand[lane * QB + qq] : K::filler();
          const Key x1 = lane + 32 < c ? cand[(lane + 32) * QB + qq] : K::filler();
          tile_select::merge_pair(lists + qq * k, k, x0, x1, K::filler(),
                                  scratch + warp * 64, lane);
        }
        __syncwarp();
        if (lane < Q_PER_WARP) cnt[warp * Q_PER_WARP + lane] = 0;
      }
      __syncthreads();  // the new lists (bounds) and empty buffers
    }
  });

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

// `max_tile` is 2048 for B4 and B5 (B5's lane field has 11 bits; B4 keeps
// the same tiles) and 8192 for B7f.
template <typename T, typename K>
int launch(const K policy, const void* q, const void* e, const void* mask,
           void* out_v, void* out_i, int b, int n, int d, int k, int tile_n,
           int max_tile, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % 64 != 0 || k < 1 || k > MAX_K ||
      k > tile_n || tile_n % 64 != 0 || tile_n > max_tile || (size_t)q % 16 != 0 ||
      (size_t)e % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile_n - 1) / tile_n;
  const size_t smem = smem_bytes(k, sizeof(typename K::Key));
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

// Every f32 bank takes the CUDA-core loop: the tensor cores would need
// TF32, a lower precision.
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
    return tc_tile::launch<tc_tile::Bf16, K, false>(
        policy, {q, nullptr, e, nullptr, mask, out_v, out_i, b, n, d, k, tile_n, 0, stream},
        max_tile);
  return launch<float>(policy, q, e, mask, out_v, out_i, b, n, d, k, tile_n, max_tile,
                       stream);
}

}  // namespace

namespace tc_tile {

// B4 over a bf16 bank on the tensor cores: tc_tile_topk.cuh's loop under
// B4's own kernel name.
template <int TQB, int KC, typename Op, typename K, bool DOTS>
__global__ void __launch_bounds__(TQB * 2 + 32)
float_tile_topk_kernel_tc(const __grid_constant__ CUtensorMap emap,
                          const unsigned char* __restrict__ q,
                          const float* __restrict__ q_scale, const float* __restrict__ e_scale,
                          const uint8_t* __restrict__ mask, float* __restrict__ out_v,
                          int* __restrict__ out_i, int b, int n, int d, int k, int tile_n,
                          int tiles, const K policy) {
#include "tc_tile_topk_loop.cuh"
}

}  // namespace tc_tile

namespace {

struct B4Kernels {
  template <int TQB, int KC, typename Op, typename K, bool DOTS>
  static auto get() { return tc_tile::float_tile_topk_kernel_tc<TQB, KC, Op, K, DOTS>; }
};

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers:
//   q [b, d] and e [n, d], both f32 (bf16 == 0) or both bf16 (bf16 != 0),
//   mask [n] bool (one byte each; on a 4-byte boundary where the tensor
//   cores run), out_v [b, tiles, k] f32, out_i [b, tiles, k] int32, with
//   tiles = ceil(n / tile_n) (B7f: the supertiles, ceil(n / lbits)).
// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
//   B4 over a bf16 bank runs on the tensor cores where they take 128
//   queries a block, or 64 with register lists (k <= 16); elsewhere (a
//   64-query block with shared-memory buffers, which ran slower than the
//   CUDA-core loop on an H100, or no plan that fits) on the CUDA-core loop.
//   topk_cuda.b4_on_tensor_cores states the same rule.
extern "C" int float_tile_topk(const void* q, const void* e, const void* mask,
                               void* out_v, void* out_i, int b, int n, int d,
                               int k, int tile_n, int bf16, void* stream) {
  const int qb = tc_tile::block_queries<tc_tile::Bf16>(d, k, sizeof(ExactKey::Key));
  if (bf16 && (qb == 128 || (qb == 64 && k <= tc_tile::KCAP)))
    return tc_tile::launch<tc_tile::Bf16, ExactKey, false, B4Kernels>(
        ExactKey{}, {q, nullptr, e, nullptr, mask, out_v, out_i, b, n, d, k, tile_n, 0, stream},
        2048);
  return launch_typed(ExactKey{}, q, e, mask, out_v, out_i, b, n, d, k, tile_n,
                      2048, bf16, stream);
}

// B4 on the CUDA-core loop over either bank, whatever the rule above says:
// the loop that B4 over bf16 leaves where the tensor cores fit, kept for
// testing and timing it beside them (not on a query path).
extern "C" int float_tile_topk_core(const void* q, const void* e, const void* mask,
                                    void* out_v, void* out_i, int b, int n, int d, int k,
                                    int tile_n, int bf16, void* stream) {
  return launch_typed(ExactKey{}, q, e, mask, out_v, out_i, b, n, d, k, tile_n, 2048, bf16,
                      stream);
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
  return tc_tile::launch<tc_tile::Bf16, PackedKey, true>(
      PackedKey{}, {q, nullptr, e, nullptr, nullptr, out, nullptr, b, n, d, 1, 2048, 0, stream},
      2048);
}
