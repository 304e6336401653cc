// Dense SPD linear algebra on one scenario's matrices in shared memory, for
// blockDim.x == NT threads.  The counterparts of sdf_nmpc_tpu/ops/qp_kernels.py
// _chol_lanes_blocked (:72), _tri_solve_lanes_blocked (:138) and
// _wood_correct (:284): there the scenario axis rode the TPU's 128 lanes and
// each step of the scalar recursion was one vector op; here one thread block
// owns one scenario and the threads split each step's rows.
//
// Matrices are row-major n x n; only the lower triangle is read or written.
// The Cholesky keeps the TPU kernel's clamp: a pivot d becomes
// d * rsqrt(max(d, 1e-30)), computed as d * (1 / sqrtf(.)) on the IEEE path.
#pragma once

#include "common.cuh"

// In-place right-looking Cholesky: lower triangle of M becomes L.
template <int NT>
__device__ void chol_block(float* M, int n) {
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;  // 2-D split of the trailing update
  for (int j = 0; j < n; ++j) {
    const float d = 1.f / sqrtf(fmaxf(M[j * n + j], 1e-30f));
    for (int i = j + 1 + t; i < n; i += NT) M[i * n + j] *= d;
    __syncthreads();
    for (int i = j + 1 + ty; i < n; i += NT / 16) {
      const float lij = M[i * n + j];
      for (int l = j + 1 + tx; l <= i; l += 16) M[i * n + l] -= lij * M[l * n + j];
    }
    if (t == 0) M[j * n + j] *= d;  // nobody reads the pivot after the scale
    __syncthreads();
  }
}

// Same factorization, one thread (for the k_s x k_s Woodbury matrix T).
__device__ __forceinline__ void chol_serial(float* M, int n) {
  for (int j = 0; j < n; ++j) {
    const float d = 1.f / sqrtf(fmaxf(M[j * n + j], 1e-30f));
    for (int i = j + 1; i < n; ++i) M[i * n + j] *= d;
    for (int i = j + 1; i < n; ++i)
      for (int l = j + 1; l <= i; ++l) M[i * n + l] -= M[i * n + j] * M[l * n + j];
    M[j * n + j] *= d;
  }
}

// L L^T X^T = B^T in place for r right-hand sides stored as the rows of X
// (r x n, row-major): X must hold B on entry.
template <int NT>
__device__ void tri_solve_block(const float* L, float* X, int n, int r) {
  const int t = threadIdx.x;
  // forward: y = L^-1 b, column by column
  for (int j = 0; j < n; ++j) {
    if (t < r) X[t * n + j] /= L[j * n + j];
    __syncthreads();
    const int m = n - 1 - j;
    for (int idx = t; idx < r * m; idx += NT) {
      const int q = idx / m, i = j + 1 + idx % m;
      X[q * n + i] -= L[i * n + j] * X[q * n + j];
    }
    __syncthreads();
  }
  // backward: x = L^-T y
  for (int j = n - 1; j >= 0; --j) {
    if (t < r) X[t * n + j] /= L[j * n + j];
    __syncthreads();
    for (int idx = t; idx < r * j; idx += NT) {
      const int q = idx / j, i = idx % j;
      X[q * n + i] -= L[j * n + i] * X[q * n + j];
    }
    __syncthreads();
  }
}

// Woodbury correction of one solved vector x (length n, shared):
// x -= Xs^T T^-1 Cs x, with T factored in Lt (k x k).  Cs, Xs: k x n.
// `u` is shared scratch of k words.
template <int NT>
__device__ void wood_correct(const float* Lt, const float* Cs, const float* Xs,
                             float* x, float* u, int n, int k) {
  const int t = threadIdx.x;
  if (t < k) {
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += Cs[t * n + j] * x[j];
    u[t] = s;
  }
  __syncthreads();
  if (t == 0) {
    for (int j = 0; j < k; ++j) {  // forward with L_T
      float acc = 0.f;
      for (int m = 0; m < j; ++m) acc += Lt[j * k + m] * u[m];
      u[j] = (u[j] - acc) / Lt[j * k + j];
    }
    for (int j = k - 1; j >= 0; --j) {  // backward with L_T^T
      float acc = 0.f;
      for (int m = j + 1; m < k; ++m) acc += Lt[m * k + j] * u[m];
      u[j] = (u[j] - acc) / Lt[j * k + j];
    }
  }
  __syncthreads();
  for (int j = t; j < n; j += NT) {
    float upd = 0.f;
    for (int m = 0; m < k; ++m) upd += Xs[m * n + j] * u[m];
    x[j] -= upd;
  }
  __syncthreads();
}
