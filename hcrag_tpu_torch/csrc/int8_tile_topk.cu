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
// Design.  All three run on the int8 tensor cores: the kernel of
// tc_tile_topk.cuh, which B5 and B7f share over a bf16 bank, with wgmma
// m64n64k32 (s32.s8.s8) from shared memory, the bank streamed by TMA into a
// ring of 64-row x 128-column chunks, the query block resident, and the
// selection in the epilogue (for B1 and B7i register lists for k <= 16,
// shared-memory lists past that; for B3e's 64-bit key shared-memory lists
// at every k, with the 32-bit value word compared before the 64-bit key is
// built).  Each key is built from the int32 sum, the query's scale (kept
// in registers) and the row's scale (loaded with its mask byte).  What
// keeps them above their bound is the epilogue: per (query, row) it does a
// B5's selection work while the int8 products take half the tensor cores'
// time of bf16 ones (PERF.md).  Blocks are ordered query block fastest, so
// all query blocks of one tile run together and read the tile from L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tc_tile_topk.cuh"

namespace {

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
// n never enter the list (the kernel checks their mask byte); its empty
// slots decode to the tile's -1e30 fill.  The kernel compares `word`, the
// key's high half, first and builds the key only where the word reaches
// the bound.
struct ExactKey {
  using Key = long long;
  __device__ static Key filler() { return LLONG_MIN; }
  __device__ static int word(int dot, float qs, float es) {
    const int bits = __float_as_int(__fadd_rn(rescaled(dot, qs, es), 0.0f));
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

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers:
//   q [b, d] int8, q_scale [b] f32, e [n, d] int8, e_scale [n] f32,
//   mask [n] bool (one byte each), out_v [b, tiles, k] f32,
//   out_i [b, tiles, k] int32, with tiles = ceil(n / tile_n) (B7i: the
//   supertiles, ceil(n / lbits)); d a multiple of 16 up to 1040, rows on
//   16-byte boundaries, e_scale on an 8-byte and mask on a 4-byte boundary.
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
  return tc_tile::launch<tc_tile::Int8, ExactKey, false>(
      ExactKey{},
      {q, q_scale, e, e_scale, mask, out_v, out_i, b, n, d, k, tile_n, 0, stream}, 2048);
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
