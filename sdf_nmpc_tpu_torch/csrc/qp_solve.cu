// The four Newton-system kernels of the composed QP path: dense SPD factor
// and solves for a batch of independent scenarios.
//
// Replaces: sdf_nmpc_tpu/ops/qp_kernels.py
//   _factor_solve_L_kernel (:200)       -> factor_solve_kernel
//   _solve_only_kernel (:242)           -> solve_kernel
//   _stiff_factor_solve_kernel (:311)   -> stiff_factor_solve_kernel
//   _stiff_resolve_kernel (:338)        -> stiff_resolve_kernel
// Semantics of the TPU kernels: the pivot clamp d * rsqrt(max(d, 1e-30)),
// the right-hand sides stored as rows, the Woodbury matrix T = Cs Xs' +
// diag(ds_inv) with the relative diagonal jitter 10 eps_f32 (|T_ii| + 1e-30)
// before its factorization, and every factor returned lower-triangular with
// zeros above the diagonal.
//
// Bound on this card: bytes.  Per scenario at n=80 the factor is ~0.17 M
// operations against 51 KB moved (M read, L written): 8192 scenarios move
// 0.42 GB, ~0.13 ms at 3.35 TB/s, while their operations take ~0.02 ms at
// the FP32 rate.  The solve kernels read L (the lower triangle only) and
// move less still.  What holds a kernel above that bound is the sequential
// chain of the factorization and the sweeps.
//
// Kernel 5 runs the blocked factorization and the warp-level solves of
// ip_dense.cuh, the helpers of the fused interior point (ip_phase.cu), which
// mirror the TPU kernel's own _chol_lanes_blocked and
// _tri_solve_lanes_blocked: one 128-thread block per scenario, the matrix
// and the right-hand-side rows in shared memory with an odd row stride
// (n | 1, free of bank conflicts on row and column walks), 2 block barriers
// per 8-column panel of the factorization and none inside the solves (each
// right-hand side belongs to one warp).  27,396 B of shared memory per block
// at n=80 and one row, so several scenarios are resident per SM
// (factor_solve_geometry reports how many).  Each element of L sees the same
// operations in the same order as in qp_device.cuh::chol_block, so L is the
// first design's bit for bit; X follows _tri_solve_lanes_blocked's order.
// Kernel 6 runs the same warp-level solves (the TPU's _solve_only_kernel
// runs _tri_solve_lanes_blocked too): with kernel 5's new X, the first
// design's column sweeps (two barriers per column) lost QP_RULE's max factor
// on one launch of chip_smoke.py's refinement check, the blocked order holds.
//
// Kernels 7 and 8 keep the first design on qp_device.cuh's unblocked
// helpers: one 128-thread block per scenario, two __syncthreads per column
// step with few threads busy in each.  Their move onto ip_dense.cuh is
// queued (ROADMAP.md section 2).

#include "common.cuh"
#include "ip_dense.cuh"
#include "qp_device.cuh"

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int WSCR_WORDS = NW * (ipd::PB * ipd::PB + ipd::PB);  // chol_blocked's scratch
constexpr float kJitter = 10.f * 1.1920928955078125e-07f;  // 10 eps_f32, exact

// Lower triangle of a row-major n x n matrix from device memory into shared
// memory with row stride ld.
__device__ __forceinline__ void load_lower(float* dst, int ld, const float* src, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += NT) {
    const int i = idx / n, j = idx % n;
    if (j <= i) dst[i * ld + j] = src[idx];
  }
}

// A factor in shared memory (row stride ld) to device memory: lower
// triangle, zeros above.
__device__ __forceinline__ void store_lower(float* dst, const float* src, int ld, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += NT) {
    const int i = idx / n, j = idx % n;
    dst[idx] = j <= i ? src[i * ld + j] : 0.f;
  }
}

// r rows of n words, row strides ldd (dst) and lds (src).
__device__ __forceinline__ void copy_rows(float* dst, int ldd, const float* src, int lds, int r,
                                          int n) {
  for (int idx = threadIdx.x; idx < r * n; idx += NT) {
    const int q = idx / n, j = idx % n;
    dst[q * ldd + j] = src[q * lds + j];
  }
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
  const int ld = n | 1;
  float* sL = smem;          // n * ld: M's lower triangle, then L
  float* sX = sL + n * ld;   // r * ld
  float* wscr = sX + r * ld;  // WSCR_WORDS
  const size_t b = blockIdx.x;
  load_lower(sL, ld, M + b * n * n, n);
  copy_rows(sX, ld, RHS + b * r * n, n, r, n);
  __syncthreads();
  ipd::chol_blocked<NT>(sL, n, ld, wscr);  // ends with a block barrier
  ipd::tri_solve_warps<NW>(sL, ld, sX, ld, n, r, threadIdx.x >> 5);
  __syncthreads();
  copy_rows(X + b * r * n, n, sX, ld, r, n);
  store_lower(L + b * n * n, sL, ld, n);
}

// Kernel 6: X = (L L')^-1 RHS (r rows) against an existing factor.
__global__ void __launch_bounds__(NT) solve_kernel(const float* L, const float* RHS, float* X,
                                                   int n, int r) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  float* sL = smem;         // n * ld
  float* sX = sL + n * ld;  // r * ld
  const size_t b = blockIdx.x;
  load_lower(sL, ld, L + b * n * n, n);
  copy_rows(sX, ld, RHS + b * r * n, n, r, n);
  __syncthreads();
  ipd::tri_solve_warps<NW>(sL, ld, sX, ld, n, r, threadIdx.x >> 5);
  __syncthreads();
  copy_rows(X + b * r * n, n, sX, ld, r, n);
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
  load_lower(sL, n, A + b * n * n, n);
  copy_rows(sX, n, RHS + b * r * n, n, r, n);
  copy_rows(sXs, n, Cs + b * k * n, n, k, n);
  copy_rows(sCs, n, Cs + b * k * n, n, k, n);
  copy_rows(sd, k, dsi + b * k, k, 1, k);
  __syncthreads();
  chol_block<NT>(sL, n);
  tri_solve_block<NT>(sL, sX, n, r + k);
  woodbury_factor(sCs, sXs, sd, sT, n, k);
  for (int q = 0; q < r; ++q) wood_correct<NT>(sT, sCs, sXs, sX + q * n, su, n, k);
  copy_rows(X + b * r * n, n, sX, n, r, n);
  copy_rows(Xs + b * k * n, n, sXs, n, k, n);
  store_lower(L + b * n * n, sL, n, n);
  store_lower(Lt + b * k * k, sT, k, k);
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
  load_lower(sL, n, L + b * n * n, n);
  copy_rows(sX, n, RHS + b * r * n, n, r, n);
  copy_rows(sCs, n, Cs + b * k * n, n, k, n);
  copy_rows(sXs, n, Xs + b * k * n, n, k, n);
  load_lower(sT, k, Lt + b * k * k, k);
  __syncthreads();
  tri_solve_block<NT>(sL, sX, n, r);
  for (int q = 0; q < r; ++q) wood_correct<NT>(sT, sCs, sXs, sX + q * n, su, n, k);
  copy_rows(X + b * r * n, n, sX, n, r, n);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return int(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

bool bad_sizes(int B, int n, int r, int k, size_t smem) {
  return B <= 0 || n <= 0 || r <= 0 || k < 0 || r + k > NT || smem > 227 * 1024;
}

size_t factor_solve_smem(int n, int r) {
  return sizeof(float) * (size_t(n | 1) * (n + r) + WSCR_WORDS);
}

}  // namespace

// Kernel 5's launch geometry at (n, r): threads per block, dynamic shared
// bytes per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int factor_solve_geometry(int n, int r, int* threads, int* smem,
                                          int* blocks_per_sm) {
  const size_t bytes = factor_solve_smem(n, r);
  if (bad_sizes(1, n, r, 0, bytes)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(factor_solve_kernel, bytes)) return err;
  *threads = NT;
  *smem = int(bytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, factor_solve_kernel,
                                                           NT, bytes));
}

SDF_NMPC_EXPORT int factor_solve_launch(const float* M, const float* RHS, float* X, float* L,
                                        int B, int n, int r, cudaStream_t stream) {
  const size_t smem = factor_solve_smem(n, r);
  if (bad_sizes(B, n, r, 0, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(factor_solve_kernel, smem)) return err;
  factor_solve_kernel<<<B, NT, smem, stream>>>(M, RHS, X, L, n, r);
  return int(cudaGetLastError());
}

SDF_NMPC_EXPORT int solve_launch(const float* L, const float* RHS, float* X, int B, int n,
                                 int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(n | 1) * (n + r);
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
