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
// with f32 sums (tc_tile_topk.cuh), which add in their own order: their keys
// equal the plain version's on exact dots and agree to rounding elsewhere
// (testing.py states how far).
//
// What bounds it on an H100: at path F1 (B4: B = 1024 queries, N = 1,001,472
// rows, D = 384, f32) it does 2*B*N*D = 0.79e12 f32 operations, 11.8 ms at
// the 67 TFLOP/s of the CUDA cores, against 1.54 GB of bank (0.46 ms at
// 3.35 TB/s); at path F2 (B5: B = 8192, bf16 bank) 6.3e12 operations, 6.4 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against a 0.77 GB bank.  Both
// are bound by operations.  The tensor-core kernel (tc_tile_topk.cuh, which
// B1 and B7i share) brings B5 and B7f within about 6x of that bound; what
// keeps them there is in PERF.md.
//
// Design of the CUDA-core kernel (as B3e's): one block takes QB = 64 queries
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

#include "float_dot.cuh"
#include "tc_tile_topk.cuh"
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
    return tc_tile::launch<tc_tile::Bf16, K, false>(
        policy, {q, nullptr, e, nullptr, mask, out_v, out_i, b, n, d, k, tile_n, 0, stream},
        max_tile);
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
  return tc_tile::launch<tc_tile::Bf16, PackedKey, true>(
      PackedKey{}, {q, nullptr, e, nullptr, nullptr, out, nullptr, b, n, d, 1, 2048, 0, stream},
      2048);
}
