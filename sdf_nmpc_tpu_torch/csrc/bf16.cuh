// PTX wrappers of the bf16 tensor-core kernel sdf_fused_bf16.cu: rounding to
// bf16, the A fragment's load from shared memory (ldmatrix) and the
// warp-wide m16n8k16 bf16 product.  sm_80 and later (built here for sm_90a).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace bf16 {

// Two floats rounded to bf16 to nearest even (cvt.rn.bf16x2.f32, the rounding
// of torch's .to(torch.bfloat16) and of JAX's astype), packed in one register
// with lo in the low half: the order of two k-adjacent fragment elements.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to bf16 to nearest even, as its 16 bits.
__device__ __forceinline__ uint16_t bits16(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// x rounded to bf16 to nearest even, as a float.
__device__ __forceinline__ float rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// a = the 16 x 16 bf16 A fragment (see mma_zero) from shared memory:
// ldmatrix.x4, whose four 8 x 8 matrices are a[0] (rows 0-7, columns 0-7),
// a[1] (rows 8-15, columns 0-7), a[2] (rows 0-7, columns 8-15) and a[3]
// (rows 8-15, columns 8-15).  Lane l gives the 16-byte aligned address of
// row l % 16's eight columns from 8 (l / 16); each 8-lane phase reads 8 rows,
// which lie in distinct banks where the row stride is 16 bytes mod 128.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// d = A B on one warp, no accumulator input: A 16 x 16 (row-major fragment
// a[4]), B 16 x 8 (column fragment b[2]), both bf16, d 16 x 8 in f32.  Lane
// l, g = l / 4, t = l % 4 holds (each register two k-adjacent elements, the
// lower k in the low half)
//   a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..2t+1], a[2] = A[g][2t+8..2t+9],
//   a[3] = A[g+8][2t+8..2t+9], b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g],
//   d[0] = D[g][2t], d[1] = D[g][2t+1], d[2] = D[g+8][2t], d[3] = D[g+8][2t+1].
// The products of bf16 operands are exact in f32.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

}  // namespace bf16
