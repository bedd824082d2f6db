// The PTX wrappers the port's tensor-core kernels share, for Hopper
// (sm_90a): cp.async copies into shared memory, ldmatrix fragment loads and
// the two mma.sync shapes, bf16 m16n8k16 and s8 m16n8k32.  Included by
// lstm_core.cuh and int8_projection.cuh.
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k32"), lane
// = 4 * g + i (g = lane / 4, i = lane % 4):
//   A (16 x K, row-major): a0 row g, a1 row g + 8, a2 row g (second k
//     half), a3 row g + 8 (second k half); each register the 4 bytes of k
//     at 4i of its half (two bf16 at k 2i, 2i+1; four s8 at k 4i..4i+3).
//   B (K x 8, "col"): b0 the 4 bytes of k at 4i of the first half, b1 of
//     the second, column g.  For s8 that is four consecutive k of one
//     output column: stored k-major (a row of each column's K codes), an
//     8 x 16-byte ldmatrix matrix over 8 columns is exactly b0 (or b1).
//   C/D (16 x 8, f32 or s32): d0, d1 row g, columns 2i, 2i+1; d2, d3 row
//     g + 8.

#pragma once

#include <cuda_runtime.h>

namespace ptx {

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// 16 bytes, or zeros where !valid (the source is not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes): lanes 8m..
// 8m+7 give the rows of matrix m, register m holds its fragment
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) @ b (32x8, col), s8 in, exact s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace

}  // namespace ptx
