// The register-tiled IEEE-f32 FFMA tile of kernel 2's CUDA-core products:
// the 'f32' route (sdf_fused.cu) and the 'mixed' route's primal rows
// (sdf_fused_bf16.cu).
//
// A thread owns NR rows x NC columns of a product Z = A W and keeps them in
// registers, acc[NR][NC].  Per reduction index k it holds NR values of A and
// NC of W and does NR x NC FMAs, so each 16-byte shared-memory load feeds 4 x
// NC (A) or 4 x NR (W) of them.  The operands come from shared memory:
//   - W: a chunk of weight rows, row-major with row stride LDW words; the
//     thread's NC columns are NC / 4 runs of four, 32 columns apart, so that
//     the 8 lanes of a warp that own different runs read 128 contiguous bytes
//     (one wavefront) and the lanes that share a run read it as a broadcast;
//   - A, one of two layouts: KMajor (the rows of one k contiguous: one load
//     brings four rows at one k) or RowMajor (the k of one row contiguous: one
//     load brings four k of one row; RowMajorDyn with its row stride known at
//     run time).  KMajorScalar reads single rows of a
//     k-major array (the 'f32' route's primal-only chunks).
// The caller places the lanes so that each warp-wide load is free of bank
// conflicts (sdf_fused.cu, sdf_fused_bf16.cu say how).
//
// Every output is one FMA chain over k in increasing order, continued from
// what acc holds: the order of the plain loop sum_k a[k] * w[k], chunk after
// chunk.  No TF32, no fast math.
#pragma once

namespace ffma_tile {

// v[0..3] = the 16-byte aligned float4 at src (shared memory)
__device__ __forceinline__ void ld4(float* v, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// A(r, k) = p[k * LDA + (r / 4) * QSTEP + r % 4]: row quads at one k.
template <int NR, int LDA, int QSTEP>
struct KMajor {
  const float* p;
  __device__ __forceinline__ void load4(int k0, float (&v)[4][NR]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < NR / 4; ++q) ld4(&v[kk][4 * q], p + (k0 + kk) * LDA + q * QSTEP);
  }
};

// A(r, k) = p[k * LDA + r * STEP], one word per load.
template <int NR, int LDA, int STEP>
struct KMajorScalar {
  const float* p;
  __device__ __forceinline__ void load4(int k0, float (&v)[4][NR]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < NR; ++r) v[kk][r] = p[(k0 + kk) * LDA + r * STEP];
  }
};

// A(r, k) = p[r * RSTEP * LDA + k]: four k of one row per load.
template <int NR, int LDA, int RSTEP>
struct RowMajor {
  const float* p;
  __device__ __forceinline__ void load4(int k0, float (&v)[4][NR]) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float x[4];
      ld4(x, p + r * RSTEP * LDA + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) v[kk][r] = x[kk];
    }
  }
};

// RowMajor with a row stride lda known at run time.
template <int NR, int RSTEP>
struct RowMajorDyn {
  const float* p;
  int lda;
  __device__ __forceinline__ void load4(int k0, float (&v)[4][NR]) const {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float x[4];
      ld4(x, p + r * RSTEP * lda + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) v[kk][r] = x[kk];
    }
  }
};

// acc[i][j] += sum_{kk < 4} A(i, k0 + kk) W(k0 + kk, j), W(k, 4 q + e) =
// w[k * LDW + 32 q + e], one FMA chain per output in k order.
template <int LDW, int NR, int NC, class A>
__device__ __forceinline__ void block4(float (&acc)[NR][NC], const A& a, const float* w, int k0) {
  float av[4][NR];
  a.load4(k0, av);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float wv[NC];
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) ld4(&wv[4 * q], w + (k0 + kk) * LDW + 32 * q);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[kk][i], wv[j], acc[i][j]);
  }
}

// The whole chunk of KC reduction indices (KC a multiple of 4).
template <int KC, int LDW, int NR, int NC, class A>
__device__ __forceinline__ void chunk(float (&acc)[NR][NC], const A& a, const float* w) {
#pragma unroll
  for (int k0 = 0; k0 < KC; k0 += 4) block4<LDW>(acc, a, w, k0);
}

}  // namespace ffma_tile
