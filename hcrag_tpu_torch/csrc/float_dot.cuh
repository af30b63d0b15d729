// float_dot.cuh — the f32 dot loop on the CUDA cores that kernel B4, B5
// and B7f over an f32 bank (float_tile_topk.cu) and B8 (kernel_sweep.cu)
// share, so that the stage-attribution kernels of B8 time the dots of the
// port's own f32 loop.  B5 and B7f over a bf16 bank run on the tensor
// cores instead (tc_tile_topk.cuh).
//
// The loop is an SGEMM-class register-tiled product, C = Q . E^T, with both
// operands row-major and depth-contiguous.  A block takes QB = 128 queries
// and walks a run of index rows in sub-tiles of RB = 128 rows; for each
// sub-tile it streams both operands through shared memory in chunks of
// KC = 8 columns, and each of its 256 threads computes an 8 x 8 block of
// dots,
//
//   acc[i][j] = dot(query query_of(i), row row_of(j) of the sub-tile),
//
// with query_of(i) = 64 (i / 4) + 4 ty + i % 4 and row_of(j) = 64 (j / 4) +
// 4 tx + j % 4.  A warp holds 4 x 8 threads (ty, tx), so that at one depth
// its threads read 4 distinct float4 of the query chunk and 8 of the row
// chunk: every shared load is one wavefront, and the rest broadcast.
//
// Bits.  Each sum is one __fmaf_rn chain over columns 0 .. d - 1 in index
// order, from 0.0f, in one thread (d is never split), and the build passes
// --fmad=false: so the sums are the same words whatever the blocking, and
// over a bf16 bank (both operands widened to f32, where their products are
// exact) they are the same words as over the f32 bank holding those values.
//
// Staging.  The operands are depth-contiguous and the loop reads them
// depth-major ("transposed": chunk[c][row]), which cp.async cannot do as it
// copies.  So each thread loads its share of the next chunk from global
// memory into registers (16 bytes of each operand over f32, 16 bytes of one
// operand over bf16) before the current chunk's FMAs, and stores it,
// widened to f32 and transposed, after them: the loads are in flight during
// the FMAs, two chunk buffers alternate, and one barrier per chunk
// publishes the next.  The chunk rows are padded to 132 floats, so that the
// transposed stores of a warp (16 rows x 2 halves over f32, 32 rows over
// bf16) fall in 32 distinct banks.  Within a chunk the fragments of depth
// c + 1 load while depth c's 64 FMAs issue (double-buffered in registers).
//
// What bounds it: 2 * 8 * 8 FMA operands a thread per depth against four
// 16-byte shared loads, and 2*B*N*D f32 operations at 67 TFLOP/s on an
// H100 (11.8 ms at path F1) against the bank's bytes (0.46 ms): the
// operations.  The query block is streamed again for each sub-tile (from
// L2: it is 1.5 MB at F1), which keeps the shared memory of the loop at
// 16.5 KB whatever d is.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace float_dot {

constexpr int QB = 128;        // queries per block
constexpr int RB = 128;        // index rows per sub-tile
constexpr int KC = 8;          // columns per staged chunk
constexpr int STRIDE = 132;    // floats per padded chunk row
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 dots each
constexpr int STAGE_FLOATS = KC * STRIDE * 2;  // one chunk of both operands
// Bytes of shared memory the loop needs: two chunk buffers, at the start
// of the block's shared memory.
constexpr size_t SMEM_BYTES = 2 * STAGE_FLOATS * sizeof(float);

// This thread's place (ty, tx) in the 16 x 16 grid: warp w holds the 4 x 8
// threads ty = 4 (w / 2) + lane / 8, tx = 8 (w % 2) + lane % 8.
__device__ __forceinline__ int thread_ty() {
  return ((threadIdx.x >> 6) << 2) + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int thread_tx() {
  return (((threadIdx.x >> 5) & 1) << 3) + (threadIdx.x & 7);
}
// The block row of this thread's query i, and the sub-tile row of its row j.
__device__ __forceinline__ int query_of(int i) { return ((i >> 2) << 6) + thread_ty() * 4 + (i & 3); }
__device__ __forceinline__ int row_of(int j) { return ((j >> 2) << 6) + thread_tx() * 4 + (j & 3); }

// One thread's share of a chunk, loaded from global memory and stored
// transposed into a chunk buffer (qs: the query chunk, es = qs + KC * STRIDE:
// the row chunk).  Queries at or past b and rows at or past `rows` are
// zeros.
template <typename T>
struct Share;

// f32: thread t loads 4 columns (half t % 2 of the chunk) of query t / 2
// and of row t / 2.
template <>
struct Share<float> {
  float4 a, e;
  __device__ __forceinline__ void load(const float* __restrict__ q, const float* __restrict__ eb,
                                       int q0, int b, int d, int row0, int rows, int col) {
    const int r = threadIdx.x >> 1, c = col + ((threadIdx.x & 1) << 2);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    a = q0 + r < b ? *reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * d + c) : z;
    e = r < rows ? *reinterpret_cast<const float4*>(eb + (size_t)(row0 + r) * d + c) : z;
  }
  __device__ __forceinline__ void store(float* qs) const {
    const int r = threadIdx.x >> 1, h = (threadIdx.x & 1) << 2;
    float* p = qs + h * STRIDE + r;
    float* s = p + KC * STRIDE;
    p[0] = a.x; p[STRIDE] = a.y; p[2 * STRIDE] = a.z; p[3 * STRIDE] = a.w;
    s[0] = e.x; s[STRIDE] = e.y; s[2 * STRIDE] = e.z; s[3 * STRIDE] = e.w;
  }
};

// bf16: threads 0-127 load the 8 columns of query t, threads 128-255 those
// of row t - 128.
template <>
struct Share<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ eb, int q0, int b,
                                       int d, int row0, int rows, int col) {
    const int r = threadIdx.x & (QB - 1);
    v = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < QB) {
      if (q0 + r < b) v = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * d + col);
    } else if (r < rows) {
      v = *reinterpret_cast<const uint4*>(eb + (size_t)(row0 + r) * d + col);
    }
  }
  __device__ __forceinline__ void store(float* qs) const {
    float* p = qs + (threadIdx.x < QB ? 0 : KC * STRIDE) + (threadIdx.x & (QB - 1));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      p[(2 * i) * STRIDE] = f.x;
      p[(2 * i + 1) * STRIDE] = f.y;
    }
  }
};

// The fragments of depth c of a chunk: this thread's 8 query values and
// its 8 row values.
__device__ __forceinline__ void fragments(const float* qs, int c, int ty, int tx, float4 (&fa)[2],
                                          float4 (&fe)[2]) {
  const float* a = qs + c * STRIDE + ty * 4;
  const float* e = qs + KC * STRIDE + c * STRIDE + tx * 4;
  fa[0] = *reinterpret_cast<const float4*>(a);
  fa[1] = *reinterpret_cast<const float4*>(a + 64);
  fe[0] = *reinterpret_cast<const float4*>(e);
  fe[1] = *reinterpret_cast<const float4*>(e + 64);
}

__device__ __forceinline__ float part(const float4 (&f)[2], int i) {
  const float4 v = f[i >> 2];
  return (i & 3) == 0 ? v.x : (i & 3) == 1 ? v.y : (i & 3) == 2 ? v.z : v.w;
}

// The dots of queries q0 .. q0 + 127 of q [b, d] with rows row0 ..
// row0 + rows - 1 of e [*, d], sub-tile by sub-tile: after the last chunk of
// the sub-tile at row0 + sub, every thread calls epilogue(acc, sub) with its
// 8 x 8 sums (acc as above).  A barrier precedes each call, and the call
// must not touch the loop's shared memory (the first SMEM_BYTES bytes of
// `smem`, where the next chunk already waits).  The loop's first barrier
// also publishes whatever the block wrote to shared memory before the call.
// d is a multiple of KC; every thread of the block calls it.
template <typename T, typename Epilogue>
__device__ __forceinline__ void tile_dots(const T* __restrict__ q, const T* __restrict__ e,
                                          float* smem, int b, int d, int q0, int row0, int rows,
                                          Epilogue&& epilogue) {
  const int ty = thread_ty(), tx = thread_tx();
  const int chunks = d / KC;
  const int steps = (rows + RB - 1) / RB * chunks;
  Share<T> share;
  share.load(q, e, q0, b, d, row0, rows, 0);
  share.store(smem);
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int kc = 0, sub = 0;  // the chunk and sub-tile of step s
  for (int s = 0; s < steps; ++s) {
    const float* qs = smem + (s & 1) * STAGE_FLOATS;
    const bool more = s + 1 < steps;
    const int nkc = kc + 1 == chunks ? 0 : kc + 1;
    const int nsub = nkc == 0 ? sub + RB : sub;
    if (more) share.load(q, e, q0, b, d, row0 + nsub, rows - nsub, nkc * KC);

    float4 fa[2][2], fe[2][2];
    fragments(qs, 0, ty, tx, fa[0], fe[0]);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c + 1 < KC) fragments(qs, c + 1, ty, tx, fa[(c + 1) & 1], fe[(c + 1) & 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(part(fa[c & 1], i), part(fe[c & 1], j), acc[i][j]);
    }

    if (more) share.store(smem + ((s + 1) & 1) * STAGE_FLOATS);
    __syncthreads();  // the next chunk is in; this one is consumed
    if (nkc == 0) {
      epilogue(acc, sub);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    kc = nkc;
    sub = nsub;
  }
}

}  // namespace float_dot
