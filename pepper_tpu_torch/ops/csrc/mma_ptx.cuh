// The PTX wrappers the port's tensor-core kernels share, for Hopper
// (sm_90a): cp.async copies into shared memory, ldmatrix fragment loads and
// the three mma.sync shapes, bf16 m16n8k16, s8 m16n8k32 and tf32 m16n8k8
// (with the 3xTF32 split that gives float32 products).  Included by
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

// d += a (16x8, row) @ b (8x8, col), tf32 in, f32 sums.  Fragments: a0 row
// g k i, a1 row g + 8 k i, a2 row g k i + 4, a3 row g + 8 k i + 4; b0 k i
// column g, b1 k i + 4; d as above.  An 8 x 4 block of floats is one
// ldmatrix matrix (8 rows of 16 bytes): lane 4g + i takes element i of row
// g, so A rows of k and B columns stored k-major load as they stand.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 split of a float32 fragment: v = hi + lo, hi = v rounded to
// tf32 (11 significant bits, ties away from zero, by integer ops) and lo =
// v - hi, exact in float32.  lo goes to the tensor cores as it stands,
// which read its top 11 bits: v's error is below 2^-21 of v.  A product
// in float32 accuracy is then a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo,
// below 2^-21 of it, is left out), three mma_tf32 into one sum; callers
// issue each of the three over all their independent tiles before the
// next, so that no mma waits on the one just issued.
template <int N>
__device__ __forceinline__ void split_tf32(const unsigned (&v)[N],
                                           unsigned (&hi)[N],
                                           unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = (v[i] + 0x1000u) & 0xFFFFE000u;
    lo[i] = __float_as_uint(
        __fsub_rn(__uint_as_float(v[i]), __uint_as_float(hi[i])));
  }
}

}  // namespace

}  // namespace ptx
