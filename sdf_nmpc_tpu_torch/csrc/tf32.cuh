// PTX wrappers of the tensor-core kernel sdf_fused_x3.cu: the TF32 rounding,
// the warp-wide m16n8k8 TF32 product, and the asynchronous copies of its
// shared-memory ring.  sm_80 and later (built here for sm_90a).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace tf32 {

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero; the
// low 13 bits of the result are zero.  The result of cvt.rna.tf32.f32 for
// every finite x and for infinities, in two integer operations at the full
// issue rate (the same outputs bit for bit on the card, the faster kernel).
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// d += A B on one warp: A 16 x 8 (row-major fragment a[4]), B 8 x 8 (column
// fragment b[2]), d 16 x 8 in f32.  Lane l, g = l / 4, t = l % 4 holds
//   a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4],
//   b[0] = B[t][g], b[1] = B[t+4][g],
//   d[0] = D[g][2t], d[1] = D[g][2t+1], d[2] = D[g+8][2t], d[3] = D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A B (no accumulator input), fragments as in mma.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// 16 bytes from global to shared memory, bypassing L1.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// 4 bytes from global to shared memory, or a zero where !valid (src is then
// not read).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32
