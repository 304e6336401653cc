// The four Newton-system kernels of the composed QP path: dense SPD factor
// and solves for a batch of independent scenarios.
//
// Replaces: sdf_nmpc_tpu/ops/qp_kernels.py
//   _factor_solve_L_kernel (:200)       -> factor_solve_kernel
//   _solve_only_kernel (:242)           -> solve_kernel
//   _stiff_factor_solve_kernel (:311)   -> stiff_factor_solve_kernel
//   _stiff_resolve_kernel (:338)        -> stiff_resolve_kernel
// with the Cholesky, tri-solve and Woodbury helpers of qp_device.cuh, the
// ones the fused interior-point kernel (ip_phase.cu) runs, so that both QP
// paths factor with one Cholesky.  Semantics of the TPU kernels: the pivot
// clamp d * rsqrt(max(d, 1e-30)), the right-hand sides stored as rows, the
// Woodbury matrix T = Cs Xs' + diag(ds_inv) with the relative diagonal
// jitter 10 eps_f32 (|T_ii| + 1e-30) before its factorization, and every
// factor returned lower-triangular with zeros above the diagonal.
//
// Bound on this card: bytes.  Per scenario at n=80 the factor is ~0.17 M
// operations against 51 KB moved (M read, L written): 8192 scenarios move
// 0.42 GB, ~0.13 ms at 3.35 TB/s, while their operations take ~0.02 ms at
// the FP32 rate.  The solve kernels read L (the lower triangle only) and
// move less still.  What holds this first version above that bound is the
// sequential chain of the factorization and the sweeps: two __syncthreads
// per column step, with few threads busy in each.
//
// Design: one thread block of NT=128 threads per scenario.  The n x n
// matrix (25.6 KB at n=80) and the right-hand-side rows sit in shared
// memory; each matrix is read from and written to device memory once, and
// only its lower triangle is read.  A simple kernel that is right comes
// first: several scenarios per block and a blocked factorization are the
// later levers, as for ip_phase.cu.

#include "common.cuh"
#include "qp_device.cuh"

namespace {

constexpr int NT = 128;
constexpr float kJitter = 10.f * 1.1920928955078125e-07f;  // 10 eps_f32, exact

// Lower triangle of a row-major n x n matrix from device memory into shared.
__device__ __forceinline__ void load_lower(float* dst, const float* src, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += NT)
    if (idx % n <= idx / n) dst[idx] = src[idx];
}

// A factor in shared memory to device memory: lower triangle, zeros above.
__device__ __forceinline__ void store_lower(float* dst, const float* src, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += NT)
    dst[idx] = idx % n <= idx / n ? src[idx] : 0.f;
}

__device__ __forceinline__ void copy_rows(float* dst, const float* src, int count) {
  for (int idx = threadIdx.x; idx < count; idx += NT) dst[idx] = src[idx];
}

// T = Cs Xs' + diag(ds_inv), jittered, factored in place (k x k, shared).
__device__ void woodbury_factor(const float* Cs, const float* Xs, const float* dsi, float* T,
                                int n, int k) {
  for (int idx = threadIdx.x; idx < k * k; idx += NT) {
    const int r = idx / k, c = idx % k;
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += Cs[r * n + j] * Xs[c * n + j];
    T[idx] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < k; ++s) {
      const float d = T[s * k + s] + dsi[s];
      T[s * k + s] = d + kJitter * (fabsf(d) + 1e-30f);
    }
    chol_serial(T, k);
  }
  __syncthreads();
}

// Kernel 5: L = chol(M), X = M^-1 RHS (r rows).
__global__ void __launch_bounds__(NT)
    factor_solve_kernel(const float* M, const float* RHS, float* X, float* L, int n, int r) {
  extern __shared__ float smem[];
  float* sL = smem;
  float* sX = sL + n * n;
  const size_t b = blockIdx.x;
  load_lower(sL, M + b * n * n, n);
  copy_rows(sX, RHS + b * r * n, r * n);
  __syncthreads();
  chol_block<NT>(sL, n);
  tri_solve_block<NT>(sL, sX, n, r);
  copy_rows(X + b * r * n, sX, r * n);
  store_lower(L + b * n * n, sL, n);
}

// Kernel 6: X = (L L')^-1 RHS (r rows) against an existing factor.
__global__ void __launch_bounds__(NT)
    solve_kernel(const float* L, const float* RHS, float* X, int n, int r) {
  extern __shared__ float smem[];
  float* sL = smem;
  float* sX = sL + n * n;
  const size_t b = blockIdx.x;
  load_lower(sL, L + b * n * n, n);
  copy_rows(sX, RHS + b * r * n, r * n);
  __syncthreads();
  tri_solve_block<NT>(sL, sX, n, r);
  copy_rows(X + b * r * n, sX, r * n);
}

// Kernel 7: factor A, solve the r rhs rows and the k Woodbury rows Cs in
// one (r + k)-row sweep, build and factor T, Woodbury-correct the r rows.
__global__ void __launch_bounds__(NT)
    stiff_factor_solve_kernel(const float* A, const float* RHS, const float* Cs,
                              const float* dsi, float* X, float* L, float* Xs, float* Lt,
                              int n, int r, int k) {
  extern __shared__ float smem[];
  float* sL = smem;               // n*n
  float* sX = sL + n * n;         // (r+k)*n: rhs rows, then the Woodbury rows
  float* sXs = sX + r * n;        // k*n (inside sX)
  float* sCs = sX + (r + k) * n;  // k*n
  float* sT = sCs + k * n;        // k*k
  float* sd = sT + k * k;         // k: ds_inv
  float* su = sd + k;             // k: Woodbury scratch
  const size_t b = blockIdx.x;
  load_lower(sL, A + b * n * n, n);
  copy_rows(sX, RHS + b * r * n, r * n);
  copy_rows(sXs, Cs + b * k * n, k * n);
  copy_rows(sCs, Cs + b * k * n, k * n);
  copy_rows(sd, dsi + b * k, k);
  __syncthreads();
  chol_block<NT>(sL, n);
  tri_solve_block<NT>(sL, sX, n, r + k);
  woodbury_factor(sCs, sXs, sd, sT, n, k);
  for (int q = 0; q < r; ++q) wood_correct<NT>(sT, sCs, sXs, sX + q * n, su, n, k);
  copy_rows(X + b * r * n, sX, r * n);
  copy_rows(Xs + b * k * n, sXs, k * n);
  store_lower(L + b * n * n, sL, n);
  store_lower(Lt + b * k * k, sT, k);
}

// Kernel 8: Woodbury-corrected solves of r rows against (L, Cs, Xs, Lt).
__global__ void __launch_bounds__(NT)
    stiff_resolve_kernel(const float* L, const float* Cs, const float* Xs, const float* Lt,
                         const float* RHS, float* X, int n, int r, int k) {
  extern __shared__ float smem[];
  float* sL = smem;          // n*n
  float* sX = sL + n * n;    // r*n
  float* sCs = sX + r * n;   // k*n
  float* sXs = sCs + k * n;  // k*n
  float* sT = sXs + k * n;   // k*k
  float* su = sT + k * k;    // k
  const size_t b = blockIdx.x;
  load_lower(sL, L + b * n * n, n);
  copy_rows(sX, RHS + b * r * n, r * n);
  copy_rows(sCs, Cs + b * k * n, k * n);
  copy_rows(sXs, Xs + b * k * n, k * n);
  load_lower(sT, Lt + b * k * k, k);
  __syncthreads();
  tri_solve_block<NT>(sL, sX, n, r);
  for (int q = 0; q < r; ++q) wood_correct<NT>(sT, sCs, sXs, sX + q * n, su, n, k);
  copy_rows(X + b * r * n, sX, r * n);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return int(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

bool bad_sizes(int B, int n, int r, int k, size_t smem) {
  return B <= 0 || n <= 0 || r <= 0 || k < 0 || r + k > NT || smem > 227 * 1024;
}

}  // namespace

SDF_NMPC_EXPORT int factor_solve_launch(const float* M, const float* RHS, float* X, float* L,
                                        int B, int n, int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (n * n + r * n);
  if (bad_sizes(B, n, r, 0, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(factor_solve_kernel, smem)) return err;
  factor_solve_kernel<<<B, NT, smem, stream>>>(M, RHS, X, L, n, r);
  return int(cudaGetLastError());
}

SDF_NMPC_EXPORT int solve_launch(const float* L, const float* RHS, float* X, int B, int n,
                                 int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (n * n + r * n);
  if (bad_sizes(B, n, r, 0, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(solve_kernel, smem)) return err;
  solve_kernel<<<B, NT, smem, stream>>>(L, RHS, X, n, r);
  return int(cudaGetLastError());
}

SDF_NMPC_EXPORT int stiff_factor_solve_launch(const float* A, const float* RHS,
                                              const float* Cs, const float* dsi, float* X,
                                              float* L, float* Xs, float* Lt, int B, int n,
                                              int r, int k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (n * n + (r + 2 * k) * n + k * k + 2 * k);
  if (k <= 0 || bad_sizes(B, n, r, k, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(stiff_factor_solve_kernel, smem)) return err;
  stiff_factor_solve_kernel<<<B, NT, smem, stream>>>(A, RHS, Cs, dsi, X, L, Xs, Lt, n, r, k);
  return int(cudaGetLastError());
}

SDF_NMPC_EXPORT int stiff_resolve_launch(const float* L, const float* Cs, const float* Xs,
                                         const float* Lt, const float* RHS, float* X, int B,
                                         int n, int r, int k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (n * n + (r + 2 * k) * n + k * k + k);
  if (k <= 0 || bad_sizes(B, n, r, k, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(stiff_resolve_kernel, smem)) return err;
  stiff_resolve_kernel<<<B, NT, smem, stream>>>(L, Cs, Xs, Lt, RHS, X, n, r, k);
  return int(cudaGetLastError());
}
