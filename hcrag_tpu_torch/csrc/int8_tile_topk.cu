// int8_tile_topk — kernels B1, B3 and B7i of the port: int8 cosine scores
// and the exact top-k of every index tile (B1, B3) or supertile (B7i).
//
// Both replace `_topk_tile_kernel_int8` (hcrag_tpu/ops/topk_pallas.py),
// launched by `pallas_cosine_top_k_int8`.  For query b and row n of tile t
// the score is
//
//   s = fp32(dot_i32(q[b], e[n])) * q_scale[b] * e_scale[n]   (in this order)
//
// B1, `int8_tile_topk`, computes the contract of the packed branches (the
// fused two-level one, which approximates it, and B3's k-pass one):
//
//   key = (bits(s + (mask[n] ? 2.0 : -3.0)) & ~0x7FF) | (2047 - (n - t * tile_n))
//
// as int32, and the k largest keys of the tile decode to
//   val = float(key & ~0x7FF) - 2.0,  idx = 2047 - (key & 0x7FF) + t * tile_n
// with a key <= 0 (masked row, row past n, or no row left) decoding to the
// filler (-1e30, -1).  Keys are unique within a tile, so the result is fully
// determined.
//
// B3e, `int8_exact_tile_topk`, computes the exact branch
// (`packed_select=False`): the tile's k best rows with mask set by the raw
// value s (-0.0 counted as +0.0), ties to the lowest row.  The TPU kernel
// adds -1e30 to masked rows and removes each pick by writing -1e30 over it,
// so once a tile's valid rows are gone every further slot is
// (-1e30, t * tile_n).  The order is B4's unique 64-bit word: the
// order-preserving f32 bits in the high half, 0xFFFFFFFF - row_in_tile in the
// low half.
//
// B7i, `int8_super_tile_topk`, replaces `_topk_tile_kernel_int8_super`
// (topk_pallas.py), launched by `pallas_cosine_top_k_int8(super_tiles > 1)`:
// B1's contract over a supertile of lbits = spt * tile_n rows (a power of
// two from 128 to 8192), with a lane field that wide,
//
//   key = (bits(s + (mask[n] ? 2.0 : -3.0)) & ~(lbits - 1)) | (lbits - 1 - r)
//
// for row r of supertile t, decoding to val = float(key & ~(lbits - 1)) - 2.0
// and idx = t * lbits + lbits - 1 - (key & (lbits - 1)).  The TPU kernel keeps
// only T candidates per 128-row lane of the supertile and can drop a row that
// shares its lane with T better ones; this kernel keeps the exact top k_sub.
// It is B1's kernel with the supertile as its tile and this key policy, so
// one block streams lbits rows, and each query writes k_sub candidates per
// supertile instead of k per 2048-row tile.
//
// Bits.  The integer dots are exact in any order (int32 sums of int8
// products), and fp32(dot) is exact while |dot| < 2^24: 127^2 * d < 2^24
// holds for d <= 1040, so every kernel here refuses a larger d.  The rescale
// and shifts use __fmul_rn / __fadd_rn (and the build passes --fmad=false):
// an FMA would change the bits.  So all three kernels equal their plain
// PyTorch versions bit for bit on every input.
//
// What bounds them on an H100: at the int8 path's shape (B = 8192 queries,
// N = 1,001,472 rows, D = 384) B1 does 2*B*N*D = 6.3e12 int8 operations
// (3.2 ms at the 1,979 TOP/s int8 tensor-core peak) and must move ~0.7 GB
// (the 385 MB bank, the candidates it writes: ~0.2 ms at 3.35 TB/s); at the
// 10M-row density paths (B = 2048, N = 10,000,384) B1, B3 and B7i do 1.57e13
// (7.9 ms) against a 3.84 GB bank (1.2 ms); B7i at S2 does B1's 6.3e12.  All
// are bound by operations.
//
// Design.  B1 and B7i run on the int8 tensor cores: the kernel of
// tc_tile_topk.cuh, which B5 and B7f share over a bf16 bank, with wgmma
// m64n64k32 (s32.s8.s8) from shared memory, the bank streamed by TMA into a
// ring of 64-row x 128-column chunks, the query block resident, and the
// selection in the epilogue (register lists for k <= 16, shared-memory
// lists past that).  Each key is built from the int32 sum, the query's
// scale (kept in registers) and the row's scale (loaded with its mask
// byte).  What keeps them above their bound is the epilogue: per (query,
// row) it does a B5's selection work while the int8 products take half the
// tensor cores' time of bf16 ones (PERF.md).  B3e, with its 64-bit key,
// keeps the first loop on the CUDA cores, the only use of __dp4a left: one
// block takes QB = 64 queries and one tile; the query block stays in shared
// memory; the tile streams through shared memory in sub-tiles of RB = 64
// rows; 256 threads each compute a 4 x 4 block of dots with 16-byte shared
// loads and __dp4a, write the keys to shared memory, and each warp filters
// the keys of its 8 queries against the current k-th best (a warp ballot)
// and inserts the few survivors into that query's sorted list in shared
// memory (tile_select.cuh).  Blocks are ordered query block fastest in both
// kernels, so all query blocks of one tile run together and read the tile
// from L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tc_tile_topk.cuh"
#include "tile_select.cuh"

namespace {

constexpr int QB = 64;          // queries per block
constexpr int RB = 64;          // index rows per staged sub-tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 dots each
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QB / WARPS;
constexpr int KEY_STRIDE = 68;  // keys per query row of the key buffer
constexpr int MAX_K = tile_select::MAX_K;
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float rescaled(int dot, float qs, float es) {
  return __fmul_rn(__fmul_rn(__int2float_rn(dot), qs), es);
}

// B1's key: the packed (score + 2 | 2047 - lane) int32.  `vs` is 1 for a
// row with mask set, 0 for a masked row or a row past n (whose scale and
// bytes are zero: its key is negative like a masked row's).
struct PackedKey {
  using Key = int;
  __device__ static Key filler() { return 0; }
  __device__ static Key make(int dot, float qs, float es, int vs, int row) {
    const float s = __fadd_rn(rescaled(dot, qs, es), vs > 0 ? 2.0f : -3.0f);
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

// B7i's key: B1's packed key with an lbits-wide lane field; `lmask` is
// lbits - 1.
struct SuperKey {
  using Key = int;
  int lmask;
  __device__ static Key filler() { return 0; }
  __device__ Key make(int dot, float qs, float es, int vs, int row) const {
    const float s = __fadd_rn(rescaled(dot, qs, es), vs > 0 ? 2.0f : -3.0f);
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

// B3e's key: order-preserving score bits | ~row.  Masked rows and rows past
// n never enter the list; its empty slots decode to the tile's -1e30 fill.
struct ExactKey {
  using Key = long long;
  __device__ static Key filler() { return LLONG_MIN; }
  __device__ static Key make(int dot, float qs, float es, int vs, int row) {
    if (vs <= 0) return LLONG_MIN;
    const int bits = __float_as_int(__fadd_rn(rescaled(dot, qs, es), 0.0f));
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

size_t smem_bytes(int d, int k, size_t key_bytes) {
  return (size_t)(QB + RB) * (d + 16) + key_bytes * (size_t)QB * (KEY_STRIDE + k) +
         sizeof(float) * (QB + RB) + sizeof(int) * RB;
}

// B3e's kernel: the dots with __dp4a on the CUDA cores, the selection by
// merges into shared-memory lists.
__global__ void __launch_bounds__(THREADS)
int8_exact_tile_topk_kernel(const int8_t* __restrict__ q, const float* __restrict__ q_scale,
                            const int8_t* __restrict__ e, const float* __restrict__ e_scale,
                            const uint8_t* __restrict__ mask, float* __restrict__ out_v,
                            int* __restrict__ out_i, int b, int n, int d, int k, int tile_n,
                            int tiles) {
  using K = ExactKey;
  using Key = K::Key;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = d + 16;  // padded rows spread the shared banks
  int8_t* q_rows = reinterpret_cast<int8_t*>(smem);
  int8_t* e_rows = q_rows + QB * row_bytes;
  Key* keys = reinterpret_cast<Key*>(e_rows + RB * row_bytes);
  Key* lists = keys + QB * KEY_STRIDE;
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
  for (int x = tid; x < QB * k; x += THREADS) lists[x] = K::filler();

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
      valid_s[tid] = in ? (mask[row] != 0) : -1;
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
            K::make(acc[i][j], qscale_s[qq], escale_s[r], valid_s[r], sub + r);
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
      K::decode(L[j], tile_base, out_v + o, out_i + o);
    }
  }
}

int launch_exact(const void* q, const void* q_scale, const void* e, const void* e_scale,
                 const void* mask, void* out_v, void* out_i, int b, int n, int d, int k,
                 int tile_n, void* stream) {
  if (b <= 0 || n <= 0 || !tc_tile::Int8::depth_ok(d) || k < 1 || k > MAX_K ||
      k > tile_n || tile_n % RB != 0 || tile_n > 2048)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile_n - 1) / tile_n;
  const size_t smem = smem_bytes(d, k, sizeof(ExactKey::Key));
  if (tiles > 65535 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_exact_tile_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QB - 1) / QB, tiles);
  int8_exact_tile_topk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)q_scale, (const int8_t*)e,
      (const float*)e_scale, (const uint8_t*)mask, (float*)out_v,
      (int*)out_i, b, n, d, k, tile_n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers:
//   q [b, d] int8, q_scale [b] f32, e [n, d] int8, e_scale [n] f32,
//   mask [n] bool (one byte each), out_v [b, tiles, k] f32,
//   out_i [b, tiles, k] int32, with tiles = ceil(n / tile_n) (B7i: the
//   supertiles, ceil(n / lbits)); d a multiple of 16 up to 1040, rows on
//   16-byte boundaries, and for B1 and B7i e_scale on an 8-byte and mask on
//   a 4-byte boundary.
// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int int8_tile_topk(const void* q, const void* q_scale,
                              const void* e, const void* e_scale,
                              const void* mask, void* out_v, void* out_i,
                              int b, int n, int d, int k, int tile_n,
                              void* stream) {
  return tc_tile::launch<tc_tile::Int8, PackedKey, false>(
      PackedKey{},
      {q, q_scale, e, e_scale, mask, out_v, out_i, b, n, d, k, tile_n, 0, stream}, 2048);
}

extern "C" int int8_exact_tile_topk(const void* q, const void* q_scale,
                                    const void* e, const void* e_scale,
                                    const void* mask, void* out_v,
                                    void* out_i, int b, int n, int d, int k,
                                    int tile_n, void* stream) {
  return launch_exact(q, q_scale, e, e_scale, mask, out_v, out_i, b, n, d, k, tile_n,
                      stream);
}

extern "C" int int8_super_tile_topk(const void* q, const void* q_scale,
                                    const void* e, const void* e_scale,
                                    const void* mask, void* out_v,
                                    void* out_i, int b, int n, int d, int k,
                                    int lbits, void* stream) {
  if (lbits < 128 || (lbits & (lbits - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  return tc_tile::launch<tc_tile::Int8, SuperKey, false>(
      SuperKey{lbits - 1},
      {q, q_scale, e, e_scale, mask, out_v, out_i, b, n, d, k, lbits, 0, stream}, 8192);
}
