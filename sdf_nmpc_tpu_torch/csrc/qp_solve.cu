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
// All four run the blocked factorization and the warp-level solves of
// ip_dense.cuh, the helpers of the fused interior point (ip_phase.cu), which
// mirror the TPU kernels' own _chol_lanes_blocked and
// _tri_solve_lanes_blocked: one 128-thread block per scenario, the matrix
// and the right-hand-side rows in shared memory with an odd row stride
// (n | 1, free of bank conflicts on row and column walks), 2 block barriers
// per 8-column panel of the factorization and none inside the solves (each
// right-hand side belongs to one warp).  Each element of L sees the same
// operations in the same order as in the first design's unblocked
// factorization, so L is that design's bit for bit; the solves follow
// _tri_solve_lanes_blocked's order.  Several scenarios are resident per SM
// (the *_geometry exports report how many).
//
// Kernel 5: 27,396 B of shared memory per block at n=80 and one row.  Kernel
// 6 runs the same warp-level solves against a given factor.
//
// Kernel 7 (29,988 B at n=80, r=1, k=8; 7 blocks per SM): the loads by
// cp.async; the r right-hand-side rows and the k rows of Cs are one
// (r + k)-row block of the solve, so the 9 rows of the main path spread over
// the 4 warps (warp 0 takes three: 6% of the kernel's time against 8 rows;
// 5 warps of two rows each were slower, at 5 blocks per SM by registers).
// After one barrier the block builds T's lower triangle and u = Cs x for each
// right-hand side, Cs read from device memory, where it stays cached (a
// shared copy costs 2.6 KB and a resident block per SM: 3% slower).  After
// another, warp 0 jitters and factors T in the scratch the factorization
// left, stores Lt, and corrects and stores the right-hand-side rows it owns,
// while the other warps store L and Xs.  With r = 1 (the main path) the
// correction follows the factor of T in the same warp, with no barrier
// between; with more rows one barrier lets each row's own warp correct it.
// The T-solves keep _wood_correct's dot-product order
// (ip_dense.cuh::wood_correct_warp).  (Times: chip_smoke.py --qp-builds on an
// H100 80GB HBM3 at 700 W, PERF.md section 6.)
// Kernel 8 (31,940 B at n=80, r=1, k=8; 7 blocks per SM): L, the rows, Cs,
// Xs and Lt loaded by cp.async (17% faster than plain loads); each row's warp
// solves it and applies its Woodbury correction with no block barrier
// between, each warp in its own scratch.
// In both, the solves' diagonal blocks divide by precomputed reciprocals
// (tri_solve_warps' kRcp, ip_dense.cuh::div_rcp): the same quotients bit for
// bit, off the chain that a sweep waits on.  On the H100 that chain, not the
// panel updates, held the first version of this design (runs in PERF.md).

#include "async_copy.cuh"
#include "common.cuh"
#include "ip_dense.cuh"

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int WSCR_WORDS = NW * (ipd::PB * ipd::PB + ipd::PB);  // chol_blocked's scratch
constexpr float kEps = 1.1920928955078125e-07f;  // eps_f32: T's jitter is 10 eps

// Lower triangle of a row-major n x n matrix from device memory into shared
// memory with row stride ld; with kAsync by cp.async (the caller waits with
// acp::wait_all before its barrier).
template <bool kAsync = false>
__device__ __forceinline__ void load_lower(float* dst, int ld, const float* src, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += NT) {
    const int i = idx / n, j = idx % n;
    if (j <= i) {
      if constexpr (kAsync)
        acp::copy4(dst + i * ld + j, src + idx);
      else
        dst[i * ld + j] = src[idx];
    }
  }
}

// A factor in shared memory (row stride ld) to device memory: lower
// triangle, zeros above; by the `count` threads from thread `first` on.
__device__ __forceinline__ void store_lower(float* dst, const float* src, int ld, int n,
                                            int first = 0, int count = NT) {
  for (int idx = int(threadIdx.x) - first; idx < n * n; idx += count) {
    const int i = idx / n, j = idx % n;
    dst[idx] = j <= i ? src[i * ld + j] : 0.f;
  }
}

// r rows of n words, row strides ldd (dst) and lds (src); by the `count`
// threads from thread `first` on.
__device__ __forceinline__ void copy_rows(float* dst, int ldd, const float* src, int lds, int r,
                                          int n, int first = 0, int count = NT) {
  for (int idx = int(threadIdx.x) - first; idx < r * n; idx += count) {
    const int q = idx / n, j = idx % n;
    dst[q * ldd + j] = src[q * lds + j];
  }
}

// copy_rows from device memory into shared memory by all threads, by
// cp.async.
__device__ __forceinline__ void load_rows_async(float* dst, int ldd, const float* src, int lds,
                                                int r, int n) {
  for (int idx = threadIdx.x; idx < r * n; idx += NT) {
    const int q = idx / n, j = idx % n;
    acp::copy4(dst + q * ldd + j, src + q * lds + j);
  }
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
    stiff_factor_solve_kernel(const float* __restrict__ A, const float* __restrict__ RHS,
                              const float* __restrict__ Cs, const float* __restrict__ dsi,
                              float* X, float* L, float* Xs, float* Lt, int n, int r, int k) {
  extern __shared__ float smem[];
  const int ld = n | 1, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float* sL = smem;                 // n * ld: A's lower triangle, then L
  float* sX = sL + n * ld;          // (r + k) * ld: the rhs rows, then Cs -> Xs
  float* sXs = sX + r * ld;
  float* wscr = sX + (r + k) * ld;  // chol_blocked's scratch, then:
  float* sT = wscr;                 //   k * k: T, then its factor
  float* su = sT + k * k;           //   r * 2k: u = Cs x per rhs row, and scratch
  const size_t b = blockIdx.x;
  const float* Cb = Cs + b * k * n;
  load_lower<true>(sL, ld, A + b * n * n, n);
  load_rows_async(sX, ld, RHS + b * r * n, n, r, n);
  load_rows_async(sXs, ld, Cb, n, k, n);
  acp::wait_all();
  __syncthreads();
  ipd::chol_blocked<NT>(sL, n, ld, wscr);  // ends with a block barrier
  ipd::tri_solve_warps<NW, true>(sL, ld, sX, ld, n, r + k, warp);
  __syncthreads();
  // T's lower triangle = Cs Xs' and u = Cs x of each rhs row, each a sum in
  // increasing column order
  for (int idx = t; idx < k * k + r * k; idx += NT) {
    const float *c, *x;
    float* dst;
    if (idx < k * k) {
      const int i = idx / k, j = idx % k;
      if (j > i) continue;
      c = Cb + i * n, x = sXs + j * ld, dst = sT + idx;
    } else {
      const int q = (idx - k * k) / k, s = (idx - k * k) % k;
      c = Cb + s * n, x = sX + q * ld, dst = su + 2 * q * k + s;
    }
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += c[j] * x[j];
    *dst = acc;
  }
  __syncthreads();
  if (warp == 0) {  // T + diag(ds_inv), jittered, factored; stored as Lt
    const float* d = dsi + b * k;
    ipd::wood_jitter_factor_warp(sT, [d](int s) { return d[s]; }, k, kEps);
    float* Ltb = Lt + b * k * k;
    for (int idx = lane; idx < k * k; idx += 32)
      Ltb[idx] = idx % k <= idx / k ? sT[idx] : 0.f;
  } else {  // meanwhile the other warps store L and Xs
    store_lower(L + b * n * n, sL, ld, n, 32, NT - 32);
    copy_rows(Xs + b * k * n, n, sXs, ld, k, n, 32, NT - 32);
  }
  if (r > 1) __syncthreads();  // T factored, for the rows of the other warps
  for (int q = warp; q < r; q += NW) {
    float* x = sX + q * ld;
    ipd::wood_correct_warp(sT, nullptr, 0, sXs, ld, x, su + 2 * q * k, n, k);
    for (int j = lane; j < n; j += 32) X[(b * r + q) * n + j] = x[j];
  }
}

// Kernel 8: Woodbury-corrected solves of r rows against (L, Cs, Xs, Lt).
__global__ void __launch_bounds__(NT)
    stiff_resolve_kernel(const float* __restrict__ L, const float* __restrict__ Cs,
                         const float* __restrict__ Xs, const float* __restrict__ Lt,
                         const float* __restrict__ RHS, float* X, int n, int r, int k) {
  extern __shared__ float smem[];
  const int ld = n | 1, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sL = smem;           // n * ld
  float* sX = sL + n * ld;    // r * ld
  float* sCs = sX + r * ld;   // k * ld
  float* sXs = sCs + k * ld;  // k * ld
  float* sT = sXs + k * ld;   // k * k: Lt
  float* su = sT + k * k;     // NW * 2k: each warp's u and scratch
  const size_t b = blockIdx.x;
  load_lower<true>(sL, ld, L + b * n * n, n);
  load_rows_async(sX, ld, RHS + b * r * n, n, r, n);
  load_rows_async(sCs, ld, Cs + b * k * n, n, k, n);
  load_rows_async(sXs, ld, Xs + b * k * n, n, k, n);
  load_rows_async(sT, k * k, Lt + b * k * k, k * k, 1, k * k);
  acp::wait_all();
  __syncthreads();
  ipd::tri_solve_warps<NW, true>(sL, ld, sX, ld, n, r, warp);  // the warp's rows, then:
  for (int q = warp; q < r; q += NW) {
    float* x = sX + q * ld;
    ipd::wood_correct_warp(sT, sCs, ld, sXs, ld, x, su + 2 * warp * k, n, k);
    for (int j = lane; j < n; j += 32) X[(b * r + q) * n + j] = x[j];
  }
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

size_t stiff_factor_solve_smem(int n, int r, int k) {
  const size_t tail = std::max(size_t(WSCR_WORDS), size_t(k) * (k + 2 * r));  // scratch, T, u
  return sizeof(float) * (size_t(n | 1) * (n + r + k) + tail);
}

size_t stiff_resolve_smem(int n, int r, int k) {
  return sizeof(float) * (size_t(n | 1) * (n + r + 2 * k) + size_t(k) * (k + 2 * NW));
}

template <typename Kernel>
int geometry(Kernel kernel, size_t bytes, int* threads, int* smem, int* blocks_per_sm) {
  if (int err = allow_smem(kernel, bytes)) return err;
  *threads = NT;
  *smem = int(bytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, NT, bytes));
}

}  // namespace

// Launch geometry of kernel 5 at (n, r), kernel 7 and kernel 8 at (n, r, k):
// threads per block, dynamic shared bytes per block and resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int factor_solve_geometry(int n, int r, int* threads, int* smem,
                                          int* blocks_per_sm) {
  const size_t bytes = factor_solve_smem(n, r);
  if (bad_sizes(1, n, r, 0, bytes)) return int(cudaErrorInvalidValue);
  return geometry(factor_solve_kernel, bytes, threads, smem, blocks_per_sm);
}

SDF_NMPC_EXPORT int stiff_factor_solve_geometry(int n, int r, int k, int* threads, int* smem,
                                                int* blocks_per_sm) {
  const size_t bytes = stiff_factor_solve_smem(n, r, k);
  if (k <= 0 || bad_sizes(1, n, r, k, bytes)) return int(cudaErrorInvalidValue);
  return geometry(stiff_factor_solve_kernel, bytes, threads, smem, blocks_per_sm);
}

SDF_NMPC_EXPORT int stiff_resolve_geometry(int n, int r, int k, int* threads, int* smem,
                                           int* blocks_per_sm) {
  const size_t bytes = stiff_resolve_smem(n, r, k);
  if (k <= 0 || bad_sizes(1, n, r, k, bytes)) return int(cudaErrorInvalidValue);
  return geometry(stiff_resolve_kernel, bytes, threads, smem, blocks_per_sm);
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
  const size_t smem = stiff_factor_solve_smem(n, r, k);
  if (k <= 0 || bad_sizes(B, n, r, k, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(stiff_factor_solve_kernel, smem)) return err;
  stiff_factor_solve_kernel<<<B, NT, smem, stream>>>(A, RHS, Cs, dsi, X, L, Xs, Lt, n, r, k);
  return int(cudaGetLastError());
}

SDF_NMPC_EXPORT int stiff_resolve_launch(const float* L, const float* Cs, const float* Xs,
                                         const float* Lt, const float* RHS, float* X, int B,
                                         int n, int r, int k, cudaStream_t stream) {
  const size_t smem = stiff_resolve_smem(n, r, k);
  if (k <= 0 || bad_sizes(B, n, r, k, smem)) return int(cudaErrorInvalidValue);
  if (int err = allow_smem(stiff_resolve_kernel, smem)) return err;
  stiff_resolve_kernel<<<B, NT, smem, stream>>>(L, Cs, Xs, Lt, RHS, X, n, r, k);
  return int(cudaGetLastError());
}
