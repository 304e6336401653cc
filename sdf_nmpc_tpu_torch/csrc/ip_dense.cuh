// Blocked and warp-level dense linear algebra on one scenario's matrices in
// shared memory, blockDim.x == NT threads in NW = NT / 32 warps: the helpers of
// kernel 4 (ip_phase.cu) and of kernels 5-8 (qp_solve.cu).  The counterparts of
// sdf_nmpc_tpu/ops/qp_kernels.py _chol_lanes_blocked (:72),
// _tri_solve_lanes_blocked (:138) and _wood_correct (:284).
//
// Every sequential recursion stays inside one warp, and one block barrier
// falls where a whole 8-column panel changes hands:
//   chol_blocked     right-looking, panel PB = 8: the diagonal block is
//                    factored by every warp at once in registers (shuffles),
//                    so each warp scales its share of the panel rows with no
//                    barrier between; then one register-tiled rank-8 update
//                    of the trailing lower triangle.  2 barriers per panel
//                    (the first design took 2 per column).
//   tri_solve_warps  each right-hand side belongs to one warp (row q to warp
//                    q % NW), which runs both sweeps alone in the blocked
//                    order of _tri_solve_lanes_blocked: the 8-column diagonal
//                    block lane by lane, then the panel update of the other
//                    rows across the lanes.  No block barrier.  The split
//                    the other way (every warp solves the diagonal block,
//                    the block's threads share the panel update over all
//                    right-hand sides, one barrier per panel) was slower on
//                    the H100 at B=8192: warm launch 25.0-25.4 against
//                    21.0-21.3 ms, stiff 14.4-14.7 against 12.3-12.5 ms
//                    (chip_smoke.py --ip-builds, same outputs bit for bit).
//   wood_*_warp      the k x k Woodbury matrix T jittered and factored, and
//                    the Woodbury correction of one solved vector, in one
//                    warp: kernel 4 solves with T in the column form
//                    (wood_apply_warp), kernels 7 and 8 in _wood_correct's
//                    dot-product form (wood_correct_warp).
//
// Matrices are row-major with a leading dimension (padded odd against bank
// conflicts).  Only the lower triangle of a factored matrix is read or
// written: its strict upper triangle is free for the caller (ip_phase.cu keeps
// H there).  Each element of the Cholesky factor sees the same operations in
// the same order as in the unblocked right-looking factorization (scale the
// column by the pivot's reciprocal square root, then subtract its rank-1
// term from the trailing triangle, column by column), with the TPU kernel's
// pivot clamp: a pivot d becomes d * (1 / sqrtf(max(d, 1e-30))), IEEE f32.
#pragma once

#include "common.cuh"

namespace ipd {

constexpr int PB = 8;  // panel width of the factorization and the solves

// Linear index k of the lower triangle of a grid of tiles -> (row, col), col <= row.
__device__ __forceinline__ void tri_index(int k, int& r, int& c) {
  r = int((sqrtf(8.f * float(k) + 1.f) - 1.f) * 0.5f);
  while (r * (r + 1) / 2 > k) --r;
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  c = k - r * (r + 1) / 2;
}

// x / d from r = 1 / d (both rounded to nearest): one Newton correction of
// x r.  Equal to x / d bit for bit wherever x, d and x / d are normal floats
// (held on 2e8 random pairs), in three multiply-adds where the division's
// reciprocal, special-case check and branch would sit on a sweep's
// dependency chain.
__device__ __forceinline__ float div_rcp(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-d, q, x), r, q);
}

// In-place Cholesky of the n x n lower triangle of S (leading dimension lds):
// it becomes L.  `wscr`: shared scratch of NW * (PB * PB + PB) words.
template <int NT>
__device__ void chol_blocked(float* S, int n, int lds, float* wscr) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float* L11 = wscr + warp * (PB * PB + PB);  // this warp's copy of the diagonal factor
  float* dinv = L11 + PB * PB;                // and its pivot scales
  for (int kb = 0; kb < n; kb += PB) {
    const int w = min(PB, n - kb);
    // (1) every warp factors the diagonal block in registers: lane l holds row l
    float a[PB];
#pragma unroll
    for (int m = 0; m < PB; ++m)
      a[m] = (lane < w && m <= lane) ? S[(kb + lane) * lds + kb + m] : 0.f;
#pragma unroll
    for (int jj = 0; jj < PB; ++jj) {
      if (jj < w) {
        const float p = __shfl_sync(0xffffffffu, a[jj], jj);
        const float d = 1.f / sqrtf(fmaxf(p, 1e-30f));
        if (lane > jj) a[jj] *= d;
#pragma unroll
        for (int m = jj + 1; m < PB; ++m) {
          const float lm = __shfl_sync(0xffffffffu, a[jj], m);
          if (lane >= m && lane < w) a[m] -= a[jj] * lm;
        }
        if (lane == jj) a[jj] = p * d;  // nobody reads the pivot after the scale
        if (lane == 0) dinv[jj] = d;
      }
    }
    if (lane < w) {
#pragma unroll
      for (int m = 0; m < PB; ++m)
        if (m <= lane) L11[lane * PB + m] = a[m];
    }
    __syncwarp();
    // (2) the panel rows below, one row per thread: L21 = A21 L11^-T, in the
    // unblocked order (scale by the pivot, then subtract column by column)
    for (int i = kb + w + t; i < n; i += NT) {
      float x[PB];
#pragma unroll
      for (int m = 0; m < PB; ++m) x[m] = m < w ? S[i * lds + kb + m] : 0.f;
#pragma unroll
      for (int jj = 0; jj < PB; ++jj) {
        if (jj < w) {
          x[jj] *= dinv[jj];
#pragma unroll
          for (int m = jj + 1; m < PB; ++m)
            if (m < w) x[m] -= x[jj] * L11[m * PB + jj];
        }
      }
#pragma unroll
      for (int m = 0; m < PB; ++m)
        if (m < w) S[i * lds + kb + m] = x[m];
    }
    __syncthreads();  // the diagonal block and the panel are read; L21 written
    // (3) warp 0 stores the diagonal factor; all threads: rank-w update of the
    // trailing lower triangle, 4 x 4 register tiles
    if (warp == 0) {
      for (int idx = lane; idx < w * w; idx += 32) {
        const int r = idx / w, c = idx % w;
        if (c <= r) S[(kb + r) * lds + kb + c] = L11[r * PB + c];
      }
    }
    const int s0 = kb + w, m = n - s0;
    const int TM = (m + 3) / 4;
    for (int tile = t; tile < TM * (TM + 1) / 2; tile += NT) {
      int tr, tc;
      tri_index(tile, tr, tc);
      const int i0 = s0 + 4 * tr, l0 = s0 + 4 * tc;
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + p, l = l0 + q;
          acc[p][q] = (i < n && l <= i) ? S[i * lds + l] : 0.f;
        }
#pragma unroll
      for (int jj = 0; jj < PB; ++jj) {
        if (jj < w) {
          float li[4], ll[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            li[p] = i0 + p < n ? S[(i0 + p) * lds + kb + jj] : 0.f;
            ll[p] = l0 + p < n ? S[(l0 + p) * lds + kb + jj] : 0.f;
          }
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] -= li[p] * ll[q];
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + p, l = l0 + q;
          if (i < n && l <= i) S[i * lds + l] = acc[p][q];
        }
    }
    __syncthreads();
  }
}

// Every lane of the warp gets rr[jj] = 1 / L[kb + jj][kb + jj] for jj < w.
__device__ __forceinline__ void diag_rcp(const float* L, int lds, int kb, int w, int lane,
                                         float (&rr)[PB]) {
  const float rc = lane < w ? 1.f / L[(kb + lane) * lds + kb + lane] : 0.f;
#pragma unroll
  for (int jj = 0; jj < PB; ++jj) rr[jj] = __shfl_sync(0xffffffffu, rc, jj);
}

// One warp solves L L^T x = b in place for the rows q = warp, warp + NW, ...
// (q < r) of X (r x n, leading dimension ldx), which hold b on entry: the
// forward then the backward sweep of _tri_solve_lanes_blocked.  Lane s takes
// row warp + NW s in the diagonal blocks; all lanes split the panel updates.
// Synchronizes the warp only; the caller puts a block barrier after it.
// kRcp (kernels 7 and 8): the same operations on the same values, scheduled
// for a shorter chain: each diagonal block's 8 reciprocals are taken across
// the lanes before it and its divisions run as div_rcp; the forward block
// adds each solved entry's terms into the later rows' sums at once (the
// terms of each sum still in increasing order).  The diagonal blocks' chain
// of divisions and shared-memory loads is what a single-row solve waits on.
template <int NW, bool kRcp = false>
__device__ void tri_solve_warps(const float* L, int lds, float* X, int ldx, int n, int r,
                                int warp) {
  const int lane = threadIdx.x & 31;
  const int nrow = warp < r ? (r - warp + NW - 1) / NW : 0;  // rows of this warp
  if (nrow == 0) return;
  // forward: y = L^-1 b
  for (int kb = 0; kb < n; kb += PB) {
    const int w = min(PB, n - kb);
    float rr[PB];
    if constexpr (kRcp) diag_rcp(L, lds, kb, w, lane, rr);
    for (int s = lane; s < nrow; s += 32) {
      float* x = X + (warp + NW * s) * ldx + kb;
      float xb[PB];
#pragma unroll
      for (int m = 0; m < PB; ++m) xb[m] = m < w ? x[m] : 0.f;
      if constexpr (kRcp) {
        float acc[PB];
#pragma unroll
        for (int m = 0; m < PB; ++m) acc[m] = 0.f;
#pragma unroll
        for (int jj = 0; jj < PB; ++jj) {
          if (jj < w) {
            xb[jj] = div_rcp(xb[jj] - acc[jj], L[(kb + jj) * lds + kb + jj], rr[jj]);
#pragma unroll
            for (int m = jj + 1; m < PB; ++m)
              if (m < w) acc[m] += L[(kb + m) * lds + kb + jj] * xb[jj];
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < PB; ++jj) {
          if (jj < w) {
            float acc = 0.f;
#pragma unroll
            for (int m = 0; m < jj; ++m) acc += L[(kb + jj) * lds + kb + m] * xb[m];
            xb[jj] = (xb[jj] - acc) / L[(kb + jj) * lds + kb + jj];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < PB; ++m)
        if (m < w) x[m] = xb[m];
    }
    __syncwarp();
    for (int s = 0; s < nrow; ++s) {
      float* x = X + (warp + NW * s) * ldx;
      for (int i = kb + w + lane; i < n; i += 32) {
        float upd = 0.f;
#pragma unroll
        for (int jj = 0; jj < PB; ++jj)
          if (jj < w) upd += L[i * lds + kb + jj] * x[kb + jj];
        x[i] -= upd;
      }
    }
    __syncwarp();
  }
  // backward: x = L^-T y
  const int kb_last = ((n - 1) / PB) * PB;
  for (int kb = kb_last; kb >= 0; kb -= PB) {
    const int w = min(PB, n - kb);
    float rr[PB];
    if constexpr (kRcp) diag_rcp(L, lds, kb, w, lane, rr);
    for (int s = lane; s < nrow; s += 32) {
      float* x = X + (warp + NW * s) * ldx + kb;
      float xb[PB];
#pragma unroll
      for (int m = 0; m < PB; ++m) xb[m] = m < w ? x[m] : 0.f;
#pragma unroll
      for (int jj = PB - 1; jj >= 0; --jj) {
        if (jj < w) {
          float acc = 0.f;
#pragma unroll
          for (int m = jj + 1; m < PB; ++m)
            if (m < w) acc += L[(kb + m) * lds + kb + jj] * xb[m];
          const float djj = L[(kb + jj) * lds + kb + jj];
          if constexpr (kRcp)
            xb[jj] = div_rcp(xb[jj] - acc, djj, rr[jj]);
          else
            xb[jj] = (xb[jj] - acc) / djj;
        }
      }
#pragma unroll
      for (int m = 0; m < PB; ++m)
        if (m < w) x[m] = xb[m];
    }
    __syncwarp();
    for (int s = 0; s < nrow; ++s) {
      float* x = X + (warp + NW * s) * ldx;
      for (int i = lane; i < kb; i += 32) {
        float upd = 0.f;
#pragma unroll
        for (int jj = 0; jj < PB; ++jj)
          if (jj < w) upd += L[(kb + jj) * lds + i] * x[kb + jj];
        x[i] -= upd;
      }
    }
    __syncwarp();
  }
}

// In one warp: T (k x k, row-major) += diag(dsi(s)) with the relative jitter
// 10 eps (|T_ss| + 1e-30), then factored in place (lower triangle) in the
// unblocked right-looking order.  `dsi`: s -> the diagonal term of row s.
template <class Dsi>
__device__ inline void wood_jitter_factor_warp(float* T, Dsi dsi, int k, float eps) {
  const int lane = threadIdx.x & 31;
  for (int s = lane; s < k; s += 32) {
    const float d = T[s * k + s] + dsi(s);
    T[s * k + s] = d + 10.f * eps * (fabsf(d) + 1e-30f);
  }
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    const float d = 1.f / sqrtf(fmaxf(T[j * k + j], 1e-30f));
    __syncwarp();
    for (int i = j + 1 + lane; i < k; i += 32) T[i * k + j] *= d;
    __syncwarp();
    for (int i = j + 1 + lane; i < k; i += 32) {
      const float lij = T[i * k + j];
      for (int l = j + 1; l <= i; ++l) T[i * k + l] -= lij * T[l * k + j];
    }
    if (lane == 0) T[j * k + j] *= d;
    __syncwarp();
  }
}

// wood_jitter_factor_warp with ds_inv = min(1 / max(eta_s, 1e-30), 1e30)
// (kernel 4).
__device__ inline void wood_factor_warp(float* T, const float* eta_s, int k, float eps) {
  wood_jitter_factor_warp(
      T, [eta_s](int s) { return fminf(1.f / fmaxf(eta_s[s], 1e-30f), 1e30f); }, k, eps);
}

// In one warp: x -= Xs^T T^-1 Cs x for one solved vector x (length n,
// shared), T factored in Lt (k x k); Cs row s is row sidx[s] of C (leading
// dimension ldc), Xs rows 0..k-1 of X.  `u`: shared scratch of k words.
// With `u_ready` the caller has already put Cs x into u.
__device__ inline void wood_apply_warp(const float* Lt, const float* C, int ldc, const int* sidx,
                                const float* X, int ldx, float* x, float* u, int n, int k,
                                bool u_ready) {
  const int lane = threadIdx.x & 31;
  if (!u_ready) {
    for (int s = lane; s < k; s += 32) {
      const float* cs = C + sidx[s] * ldc;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += cs[j] * x[j];
      u[s] = acc;
    }
    __syncwarp();
  }
  for (int j = 0; j < k; ++j) {  // forward with L_T, column by column
    if (lane == 0) u[j] = u[j] / Lt[j * k + j];
    __syncwarp();
    for (int i = j + 1 + lane; i < k; i += 32) u[i] -= Lt[i * k + j] * u[j];
    __syncwarp();
  }
  for (int j = k - 1; j >= 0; --j) {  // backward with L_T^T
    if (lane == 0) u[j] = u[j] / Lt[j * k + j];
    __syncwarp();
    for (int i = lane; i < j; i += 32) u[i] -= Lt[j * k + i] * u[j];
    __syncwarp();
  }
  for (int j = lane; j < n; j += 32) {
    float upd = 0.f;
    for (int m = 0; m < k; ++m) upd += X[m * ldx + j] * u[m];
    x[j] -= upd;
  }
  __syncwarp();
}

// In one warp, _wood_correct's order: x -= Xs^T T^-1 Cs x for one solved
// vector x (length n, shared), T factored in Lt (k x k, lower), Cs and Xs k
// rows of leading dimension ldc and ldx.  `u`: shared scratch of 2 k words
// (u, then the reciprocals of Lt's diagonal); a null Cs means the caller has
// already put Cs x into u.  u = Cs x one row per lane, each a sum in
// increasing column order; the two T-solves on lane 0 in the dot-product form
// (each entry's terms summed in increasing index, then divided by the pivot,
// as div_rcp); the update across the lanes, each entry's k terms in
// increasing order.
__device__ inline void wood_correct_warp(const float* Lt, const float* Cs, int ldc,
                                         const float* Xs, int ldx, float* x, float* u, int n,
                                         int k) {
  const int lane = threadIdx.x & 31;
  if (Cs != nullptr) {
    for (int s = lane; s < k; s += 32) {
      const float* cs = Cs + s * ldc;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += cs[j] * x[j];
      u[s] = acc;
    }
    __syncwarp();
  }
  float* rt = u + k;
  for (int s = lane; s < k; s += 32) rt[s] = 1.f / Lt[s * k + s];
  __syncwarp();
  if (lane == 0) {
    for (int j = 0; j < k; ++j) {  // forward with L_T
      float acc = 0.f;
      for (int m = 0; m < j; ++m) acc += Lt[j * k + m] * u[m];
      u[j] = div_rcp(u[j] - acc, Lt[j * k + j], rt[j]);
    }
    for (int j = k - 1; j >= 0; --j) {  // backward with L_T^T
      float acc = 0.f;
      for (int m = j + 1; m < k; ++m) acc += Lt[m * k + j] * u[m];
      u[j] = div_rcp(u[j] - acc, Lt[j * k + j], rt[j]);
    }
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    float upd = 0.f;
    for (int m = 0; m < k; ++m) upd += Xs[m * ldx + j] * u[m];
    x[j] -= upd;
  }
  __syncwarp();
}

// In one warp: zero x (length n, shared) unless every entry is finite.
__device__ __forceinline__ void zero_unless_finite_warp(float* x, int n) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int j = lane; j < n; j += 32) ok = ok && isfinite(x[j]);
  if (!__all_sync(0xffffffffu, ok))
    for (int j = lane; j < n; j += 32) x[j] = 0.f;
  __syncwarp();
}

}  // namespace ipd
