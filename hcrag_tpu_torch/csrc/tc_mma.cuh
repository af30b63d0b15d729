// tc_mma.cuh — the tensor-core pieces of kernels B1 and B7i over an int8
// bank and of B5 and B7f over a bf16 bank (tc_tile_topk.cuh): the swizzled
// shared-memory layout, the copies that fill it (cp.async for the query
// block, the Tensor Memory Accelerator with mbarriers for the bank's rows),
// and the wgmma calls that take their operands from it.
//
// Layout: an operand is held as chunks of 128 bytes of each row (64 bf16 or
// 128 int8 columns); one chunk of R rows takes R * 128 bytes, row r's eight
// 16-byte segments stored in the order seg ^ (r & 7): the hardware's
// 128-byte swizzle, which both the TMA (CU_TENSOR_MAP_SWIZZLE_128B) and
// wgmma read and write.
//
// The products of bf16 values are exact; how the tensor core adds them is
// its own, so the sums agree with a chain of f32 FMAs only to rounding
// (exactly where every partial sum is representable, as on dyadic inputs).
// The int8 products add in int32, exactly in any order.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc_mma {

// Byte offset of 16-byte segment `seg` of row `row` in a chunk.
__device__ __forceinline__ uint32_t swz(int row, int seg) {
  return (uint32_t)(row * 128 + (((seg ^ row) & 7) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; `bytes` 0 fills zeros (src is not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- wgmma: a warpgroup (4 warps, 128 threads) multiplies from shared
// memory.  Both operands are K-major chunks in the layout above, which is
// the hardware's 128-byte swizzle when a chunk starts on a 1024-byte
// boundary: 8-row atoms of 1024 bytes (the stride), and a k-step of 32
// bytes (16 bf16 or 32 int8 columns) inside the 128-byte atom moves the start
// address by 32 bytes.

// The matrix descriptor of a K-major, 128-byte-swizzled operand at `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)  // start address
         | (uint64_t)1 << 16                 // leading offset (unused when swizzled)
         | (uint64_t)(1024 >> 4) << 32       // stride between 8-row atoms
         | (uint64_t)1 << 62;                // 128-byte swizzle
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, f32 sums in the warpgroup's
// registers: thread (warp w, lane l) holds, for j < 8, d[4 j + r] at query
// 16 w + l / 4 + 8 (r / 2) and row 8 j + 2 (l % 4) + r % 2.  `acc` 0
// overwrites d.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// The same product over int8: d[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T
// with signed int8 operands and exact int32 sums, in the fragment layout
// above.
__device__ __forceinline__ void wgmma_64x64(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of d across the wait.
__device__ __forceinline__ void wg_fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wg_fence_operands(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// Order this thread's generic-proxy writes to shared memory (cp.async)
// before the tensor cores' async-proxy reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- mbarriers and the Tensor Memory Accelerator.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of copies to complete.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Box (c0, c1) of a 2-D tensor map (c0 innermost) into shared memory at
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

}  // namespace tc_mma
