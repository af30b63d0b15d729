// float_dot.cuh — the float dot loop on the CUDA cores that kernel B4, B5
// and B7f over an f32 bank (float_tile_topk.cu) and B8 (kernel_sweep.cu)
// share, so that the stage-attribution kernels of B8 time the dots of the
// port's own f32 loop.  B5 and B7f over a bf16 bank run on the tensor
// cores instead (tc_tile_topk.cuh).
//
// A block takes QB = 64 queries.  `stage_queries` keeps them in shared memory
// as f32, each row padded to d + 4 floats so that the threads' 16-byte loads
// spread over the shared banks; rows past the batch are zeros.
// `sub_tile_dots` then computes the block's dots with RB = 64 index rows at a
// time: the rows stream through shared memory in chunks of DC = 64 columns,
// widened to f32, and each of the 256 threads (tq, tr) = (tid / 16, tid % 16)
// computes a 4 x 4 block of dots,
//
//   acc[i][j] = dot(query tq * 4 + i, row tr + 16 * j of the sub-tile),
//
// accumulated in f32 with __fmaf_rn in index order.  For a bf16 bank the
// products of bf16 values are exact in f32; for an f32 bank they are full
// f32 FMAs (no TF32).  The dots run on the CUDA cores: at 2*B*N*D operations
// this loop, and not the memory, bounds every kernel that uses it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace float_dot {

constexpr int QB = 64;          // queries per block
constexpr int RB = 64;          // index rows per staged sub-tile
constexpr int DC = 64;          // columns per staged chunk
constexpr int E_STRIDE = DC + 4;
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 dots each

// Floats of shared memory the loop needs: the query block and one staged
// chunk.  The query block comes first, at the start of the buffer.
inline size_t smem_floats(int d) {
  return (size_t)QB * (d + 4) + (size_t)RB * E_STRIDE;
}

// Eight consecutive values of a row, widened to f32 (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Queries q0 .. q0 + QB - 1 of q [b, d] into q_rows (row stride d + 4) as
// f32; rows at or past b are zeros.  The first barrier of `sub_tile_dots`
// orders these stores before any thread reads them.
template <typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, float* q_rows,
                                              int q0, int b, int d) {
  const int q_stride = d + 4;
  const int q_chunks = d / 8;
  for (int x = threadIdx.x; x < QB * q_chunks; x += THREADS) {
    const int r = x / q_chunks, c = x - r * q_chunks;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < b) load8(q + (size_t)(q0 + r) * d + c * 8, v);
    store8(q_rows + r * q_stride + c * 8, v);
  }
}

// The dots of the block's queries with rows tile_base + sub .. + 63 of
// e [n, d] (rows at or past tile_base + rows_here count as zeros) into acc,
// as above.  `on_chunk(dc)` runs on every thread after it stages its share of
// chunk dc and before the barrier that publishes the chunk: B4, B5 and B7f
// stage their row flags there.  The loop opens each chunk with a barrier, so
// whatever the block wrote to shared memory after the previous sub-tile
// (B5's keys) has been read before the chunk buffer is overwritten.
template <typename T, typename OnChunk>
__device__ __forceinline__ void sub_tile_dots(const T* __restrict__ e, const float* q_rows,
                                              float* e_rows, int d, int tile_base, int sub,
                                              int rows_here, float (&acc)[4][4],
                                              OnChunk&& on_chunk) {
  const int tid = threadIdx.x;
  const int tq = tid >> 4;  // queries tq*4 .. tq*4+3
  const int tr = tid & 15;  // rows tr, tr+16, tr+32, tr+48 of the sub-tile
  const int q_stride = d + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int dc = 0; dc < d; dc += DC) {
    __syncthreads();  // the staged chunk (and the last keys) are consumed
    for (int x = tid; x < RB * (DC / 8); x += THREADS) {
      const int r = x / (DC / 8), c = x - r * (DC / 8);
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (sub + r < rows_here)
        load8(e + (size_t)(tile_base + sub + r) * d + dc + c * 8, v);
      store8(e_rows + r * E_STRIDE + c * 8, v);
    }
    on_chunk(dc);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < DC; c += 4) {
      float4 qv[4], ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            q_rows + (tq * 4 + i) * q_stride + dc + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ev[j] = *reinterpret_cast<const float4*>(
            e_rows + (tr + 16 * j) * E_STRIDE + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = __fmaf_rn(qv[i].x, ev[j].x, a);
          a = __fmaf_rn(qv[i].y, ev[j].y, a);
          a = __fmaf_rn(qv[i].z, ev[j].z, a);
          a = __fmaf_rn(qv[i].w, ev[j].w, a);
          acc[i][j] = a;
        }
    }
  }
}

}  // namespace float_dot
