// Inline-PTX building blocks of the port's tensor-core kernels for Hopper
// (sm_90a): 16-byte asynchronous copies into shared memory, ldmatrix
// fragment loads, the bf16 m16n8k16 mma.sync with fp32 accumulators, and
// bf16 packing.  Fragment layouts are PTX's (ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 regs of 2 bf16:
//     a0 (row g, cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g, cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B (16 x 8, one column's k values adjacent), 2 regs:
//     b0 (k 2t, 2t+1; col g)      b1 (k 2t+8, 2t+9; col g)
//   C/D (16 x 8 fp32), 4 floats:
//     c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g+8, cols 2t, 2t+1)
// So the accumulators of two adjacent 16 x 8 tiles, rounded to bf16 and
// packed in pairs, are the A fragment of one k16 step.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; the bytes past src_bytes (0 or
// 16) are zero-filled, so src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a . b on one 16 x 8 x 16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

}  // namespace
