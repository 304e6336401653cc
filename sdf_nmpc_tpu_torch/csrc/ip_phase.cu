// One phase (n_iters Mehrotra predictor-corrector iterations) of the
// condensed-QP interior point, for a batch of independent scenarios.
//
// Replaces: sdf_nmpc_tpu/ops/ip_kernel.py _ip_phase_kernel (:78), with the
// Cholesky / tri-solve / Woodbury helpers of ops/qp_kernels.py (:72, :138,
// :284) inside (here ip_dense.cuh).  Semantics follow that kernel and
// solver/qp.py line by line: noise-aware gap floors, KKT residuals, the
// best-iterate merit at body entry (gated off at global iteration 0), the
// mild-row ratio cap, top-k_s stiff rows on the RAW eta in argmax_better's
// order (NaN first, ties to the lower index), the Newton matrix A = H + C'
// diag(eta_mild) C + diag(rb) with a 10 eps (|d| + 1) diagonal jitter, the
// predictor rhs riding as row k_s of the (k_s + 1)-RHS tri-solve, T = Cs Xs' +
// diag(1/eta_s) jittered and factored, non-finite directions zeroed per
// scenario, tau = 0.995, sigma = clip((mu_aff / mu)^3, 1e-4, 1), the mu_min /
// p_floor / d_floor floors, and the tail sum of the last n_tail iterates.
// H is read by its lower triangle (it is symmetric), as the Cholesky reads A.
//
// Bound on this card: operations, 1.340 ms per B=8192 steady step for the two
// launches (chip_smoke.py::ip_ops_per_iter, ~0.8 MFLOP per iteration and
// scenario; H and C, ~0.45 GB, are read once per phase, ~0.13 ms).  The step
// is latency-bound, not FLOP-bound: an 80 x 80 factorization per scenario is a
// chain of small dependent steps.  So the arithmetic stays IEEE f32 on the CUDA
// cores (no fast math, no approximate rsqrt or division, no TF32 / bf16
// tensor-core products): the interior point is precision-critical, and tensor
// cores would not shorten the chain.
//
// The first design took 97.26 ms per step on an H100 80GB HBM3 at 700 W
// (chip_smoke.py): one 256-thread block per scenario, 78 KB of shared memory
// (2 blocks per SM), and about 850 block barriers per iteration (2 per column
// of the Cholesky and of each tri-solve sweep, 16 for top-k by argmax-and-mask,
// ~30 in reductions) with one or a few threads busy between most of them, T
// factored and the Woodbury substitutions run on thread 0.
//
// This design: one 128-thread block (4 warps) per scenario, so that 4 blocks
// fit on an SM; thread t owns elements t, t + 128 of every nz- and nc-vector
// in registers (EPT = 1 or 2 elements per thread).  Shared memory holds
//   S  nz x (nz|1): H's strict lower triangle, transposed into the strict
//      upper triangle, and the Newton matrix / its factor in the lower one;
//      H's diagonal apart (so H is never copied per iteration),
//   C  nc x (nz|1) (odd row stride: row and column walks are both free of
//      bank conflicts), X (k_s+1) x (nz|1), T k_s x k_s, a few vectors;
// the stiff rows of C are read through their indices, not copied.
// 52.4 KB at nz=80, nc=63, k_s=8.  Per iteration:
//   - the Newton matrix: 4 x 4 register tiles of the lower triangle, 16 FMAs
//     per 8 shared loads;
//   - Cholesky: blocked right-looking, panel 8 (ip_dense.cuh::chol_blocked),
//     2 barriers per panel;
//   - tri-solves: each right-hand side in one warp, in the blocked order of
//     _tri_solve_lanes_blocked, no block barrier inside (faster on the card
//     than the panel update split across the warps with a barrier per
//     panel, even for one right-hand side: see ip_dense.cuh);
//   - top-k_s by rank: each row counts the rows that beat it under
//     argmax_better, rank < k_s is stiff at position rank (the same set in
//     the same order as k_s rounds of argmax-and-mask), one barrier;
//   - T factored and both Woodbury corrections in warp 0;
//   - the reductions fused (merit and complementarity in one), one barrier
//     each, and the end-of-iteration mu only in the last iteration.
// About 34 block barriers per stiff iteration at nz=80 (20 in the Cholesky),
// 31 per warm one, against about 850.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 34.21 ms per B=8192
// steady step, the warm launch (k_s=0, 11 iterations) 21.13 ms and the stiff
// one (k_s=8, 4 iterations) 13.09 ms: 3.9% of the bound.  ptxas: 124
// registers, no spills, for one element per thread (186 for two); 128
// threads, 52,404 B of shared memory per block and 4 resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  What remains is latency:
// the pivot chain of the factorization and the single-warp solves, with the
// SM shared by 4 blocks.

#include "common.cuh"
#include "ip_dense.cuh"

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int RED_WORDS = 2 * NW * 8;
constexpr int WSCR_WORDS = NW * (ipd::PB * ipd::PB + ipd::PB);
constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory of one block (sm_90)

struct PhaseArgs {
  // data (batch-first, contiguous): H (B,nz,nz), C (B,nc,nz), g/lb/ub (B,nz),
  // c0/lh/uh/z1/z2 (B,nc)
  const float *H, *C, *g, *c0, *lh, *uh, *z1, *z2, *lb, *ub;
  // state in: dz,sl,su,ll,lu,gl,gu,nl,nu, mu (B,), bdz (B,nz), bm (B,), dzs (B,nz)
  const float *dz, *sl, *su, *ll, *lu, *gl, *gu, *nl, *nu, *mu, *bdz, *bm, *dzs;
  float *o_dz, *o_sl, *o_su, *o_ll, *o_lu, *o_gl, *o_gu, *o_nl, *o_nu, *o_mu, *o_bdz,
      *o_bm, *o_dzs;
  int nz, nc, ks, n_iters, it0, n_tail;
  float ratio_cap, mu_min, p_floor, d_floor, tau;
};

__device__ __forceinline__ float max_step(float v, float dv) {
  return dv < 0.f ? -v / dv : CUDART_INF_F;
}

// per-element state carried across iterations
struct ZState { float g, lb, ub, dz, nl, nu, bdz, dzs; };
struct CState { float c0, lh, uh, z1, z2, sl, su, ll, lu, gl, gu; };

template <int EPT, int MINB>
__global__ void __launch_bounds__(NT, MINB) ip_phase_kernel(PhaseArgs a) {
  extern __shared__ float smem[];
  const int nz = a.nz, nc = a.nc, ks = a.ks;
  const int b = blockIdx.x, t = threadIdx.x, warp = t >> 5;
  const float eps = 1.1920928955078125e-07f;  // f32 machine epsilon
  const float n_terms = float(2 * nz + 4 * nc);
  const int ld = nz | 1;  // row stride of S, C and X

  float* S = smem;                 // nz * ld: H (strict upper), A / L (lower)
  float* dH = S + nz * ld;         // nz: H's diagonal
  float* Cm = dH + nz;             // nc * ld
  float* X = Cm + nc * ld;         // (ks+1) * ld: [Cs' solves; rhs]
  float* T = X + (ks + 1) * ld;    // ks * ks
  float* vz = T + ks * ks;         // nz: shared z-vector
  float* vc = vz + nz;             // nc: shared c-vector
  float* v2 = vc + nc;             // nc: the right-hand sides' c-vector
  float* vm = v2 + nc;             // nc: raw eta of the stiff-row ranking
  float* vds = vm + nc;            // ks: exact stiff coefficients
  float* u = vds + ks;             // ks: Woodbury scratch
  float* red = u + ks;             // RED_WORDS: reduction scratch
  float* wscr = red + RED_WORDS;   // WSCR_WORDS: the factorization's warp scratch
  int* sidx = reinterpret_cast<int*>(wscr + WSCR_WORDS);  // ks: stiff rows in order
  float* xr = X + ks * ld;         // the predictor / corrector solve
  int slot = 0;

  {
    const float* Hb = a.H + size_t(b) * nz * nz;
    for (int idx = t; idx < nz * nz; idx += NT) {
      const int r = idx / nz, c = idx % nz;
      if (c < r) S[c * ld + r] = Hb[idx];
      else if (c == r) dH[r] = Hb[idx];
    }
    const float* Cb = a.C + size_t(b) * nc * nz;
    for (int idx = t; idx < nc * nz; idx += NT) Cm[(idx / nz) * ld + idx % nz] = Cb[idx];
  }

  ZState z[EPT];
  CState c[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = t + e * NT;
    const size_t zo = size_t(b) * nz + i, co = size_t(b) * nc + i;
    z[e] = ZState{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i < nz)
      z[e] = ZState{a.g[zo], a.lb[zo], a.ub[zo], a.dz[zo], a.nl[zo], a.nu[zo], a.bdz[zo],
                    a.dzs[zo]};
    c[e] = CState{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 1.f, 0.f, 0.f, 0.f, 0.f};
    if (i < nc)
      c[e] = CState{a.c0[co], a.lh[co], a.uh[co], a.z1[co], a.z2[co], a.sl[co], a.su[co],
                    a.ll[co], a.lu[co], a.gl[co], a.gu[co]};
  }
  float best_m = a.bm[b];
  float mu = a.mu[b];
  __syncthreads();

  for (int it = 0; it < a.n_iters; ++it) {
    // ---- shared copies of dz and lam_l - lam_u ----
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      if (i < nz) vz[i] = z[e].dz;
      if (i < nc) vc[i] = c[e].ll - c[e].lu;
    }
    __syncthreads();

    // ---- gaps with cancellation-noise floors; KKT stationarity residuals ----
    float w[EPT], tl[EPT], tu[EPT], bl[EPT], bu[EPT], Hdz[EPT], r_z[EPT], r_sl[EPT],
        r_su[EPT];
    float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // merit terms, then complementarity
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      const bool hz = i < nz, hc = i < nc;
      const ZState& Z = z[e];
      const CState& K = c[e];
      float s = 0.f;
      if (hc) {
        const float* row = Cm + i * ld;
        for (int j = 0; j < nz; ++j) s += row[j] * vz[j];
      }
      w[e] = K.c0 + s;
      tl[e] = fmaxf(w[e] + K.sl - K.lh, 4.f * eps * (1.f + fabsf(w[e]) + K.sl));
      tu[e] = fmaxf(K.uh + K.su - w[e], 4.f * eps * (1.f + fabsf(w[e]) + K.su));
      bl[e] = fmaxf(Z.dz - Z.lb, 4.f * eps * (1.f + fabsf(Z.dz)));
      bu[e] = fmaxf(Z.ub - Z.dz, 4.f * eps * (1.f + fabsf(Z.dz)));
      float h = 0.f;
      r_z[e] = 0.f;
      if (hz) {
        for (int j = 0; j < nz; ++j) {
          const float hij = j == i ? dH[i] : S[j < i ? j * ld + i : i * ld + j];
          h += hij * vz[j];
        }
        float ctv = 0.f;
        for (int l = 0; l < nc; ++l) ctv += Cm[l * ld + i] * vc[l];
        r_z[e] = h + Z.g - ctv - Z.nl + Z.nu;
      }
      Hdz[e] = h;
      r_sl[e] = K.z1 + K.z2 * K.sl - K.ll - K.gl;
      r_su[e] = K.z1 + K.z2 * K.su - K.lu - K.gu;
      const float vl = fmaxf(K.lh - w[e], 0.f), vu_ = fmaxf(w[e] - K.uh, 0.f);
      if (hz) {
        sums[0] += Z.dz * h;
        sums[1] += Z.g * Z.dz;
        sums[3] += (Z.dz - Z.lb) * Z.nl + (Z.ub - Z.dz) * Z.nu;
      }
      if (hc) {
        sums[2] += K.z1 * (vl + vu_) + 0.5f * K.z2 * (vl * vl + vu_ * vu_);
        sums[4] += (w[e] + K.sl - K.lh) * K.ll + (K.uh + K.su - w[e]) * K.lu + K.sl * K.gl +
                   K.su * K.gu;
      }
    }
    block_sum<NT, 5>(sums, red, slot);

    // ---- best-iterate merit at entry (gate excludes the zero step) ----
    {
      const float m_cur = 0.5f * sums[0] + sums[1] + sums[2];
      if (m_cur < best_m && (a.it0 + it) > 0) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) z[e].bdz = z[e].dz;
        best_m = m_cur;
      }
    }
    const float mu_cur = (sums[3] + sums[4]) / n_terms;

    // ---- barrier ratios + stiff rows by rank of the raw eta ----
    float ql_raw[EPT], qu_raw[EPT], pl_raw[EPT], pu_raw[EPT];
    int my_s[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const bool hc = t + e * NT < nc;
      ql_raw[e] = hc ? c[e].ll / tl[e] : 0.f;
      qu_raw[e] = hc ? c[e].lu / tu[e] : 0.f;
      pl_raw[e] = hc ? c[e].gl / c[e].sl : 0.f;
      pu_raw[e] = hc ? c[e].gu / c[e].su : 0.f;
      my_s[e] = -1;
    }
    if (ks > 0) {
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int i = t + e * NT;
        if (i < nc) {
          const float z2 = c[e].z2;
          const float dl0 = z2 + ql_raw[e] + pl_raw[e], du0 = z2 + qu_raw[e] + pu_raw[e];
          vm[i] = ql_raw[e] * (z2 + pl_raw[e]) / dl0 + qu_raw[e] * (z2 + pu_raw[e]) / du0;
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int i = t + e * NT;
        if (i < nc) {
          const float v = vm[i];
          int rank = 0;
          for (int l = 0; l < nc; ++l) rank += argmax_better(vm[l], l, v, i) ? 1 : 0;
          if (rank < ks) {
            my_s[e] = rank;
            sidx[rank] = i;
          }
        }
      }
    }
    float ql[EPT], qu[EPT], pl[EPT], pu[EPT], d_l[EPT], d_u[EPT], rbl[EPT], rbu[EPT];
    float a_l0[EPT], a_u0[EPT], b_l0[EPT], b_u0[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      const bool hz = i < nz, hc = i < nc;
      const CState& K = c[e];
      const float cap = my_s[e] >= 0 ? CUDART_INF_F : a.ratio_cap;
      ql[e] = fminf(ql_raw[e], cap);
      qu[e] = fminf(qu_raw[e], cap);
      pl[e] = fminf(pl_raw[e], cap);
      pu[e] = fminf(pu_raw[e], cap);
      d_l[e] = K.z2 + ql[e] + pl[e];
      d_u[e] = K.z2 + qu[e] + pu[e];
      const float eta = hc ? ql[e] * (K.z2 + pl[e]) / d_l[e] + qu[e] * (K.z2 + pu[e]) / d_u[e]
                           : 0.f;
      rbl[e] = hz ? z[e].nl / bl[e] : 0.f;
      rbu[e] = hz ? z[e].nu / bu[e] : 0.f;
      if (my_s[e] >= 0) vds[my_s[e]] = eta;  // exact (uncapped) stiff coefficient
      if (hc) vc[i] = my_s[e] >= 0 ? 0.f : eta;  // eta_mild
      if (hz) vz[i] = rbl[e] + rbu[e];
      // predictor rhs coefficients (targets = 0)
      a_l0[e] = 0.f / tl[e] - K.ll;
      a_u0[e] = 0.f / tu[e] - K.lu;
      b_l0[e] = -r_sl[e] + a_l0[e] + 0.f / K.sl - K.gl;
      b_u0[e] = -r_su[e] + a_u0[e] + 0.f / K.su - K.gu;
      if (hc)
        v2[i] = (a_l0[e] - ql[e] * b_l0[e] / d_l[e]) - (a_u0[e] - qu[e] * b_u0[e] / d_u[e]);
    }
    __syncthreads();

    // ---- Newton matrix, lower triangle: H + C' diag(eta_mild) C + diag(rb) ----
    {
      const int TZ = (nz + 3) / 4;
      for (int tile = t; tile < TZ * (TZ + 1) / 2; tile += NT) {
        int tr, tc;
        ipd::tri_index(tile, tr, tc);
        const int r0 = 4 * tr, j0 = 4 * tc;
        int rr[4], jj[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          rr[p] = min(r0 + p, nz - 1);
          jj[p] = min(j0 + p, nz - 1);
        }
        float acc[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
        for (int i = 0; i < nc; ++i) {
          const float* row = Cm + i * ld;
          const float ei = vc[i];
          float cr[4], cj[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            cr[p] = row[rr[p]] * ei;
            cj[p] = row[jj[p]];
          }
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] += cr[p] * cj[q];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + p, j = j0 + q;
            if (r < nz && j <= r) {
              float v = (j < r ? S[j * ld + r] : dH[r]) + acc[p][q];
              if (r == j) {
                v = v + vz[j];
                v = v + 10.f * eps * (fabsf(v) + 1.f);
              }
              S[r * ld + j] = v;
            }
          }
      }
    }
    // the stiff rows of C as the first k_s right-hand sides, the predictor rhs last
    for (int idx = t; idx < ks * nz; idx += NT) {
      const int s = idx / nz, j = idx % nz;
      X[s * ld + j] = Cm[sidx[s] * ld + j];
    }
    float rhs_base[EPT];  // -r_z; the rest of each rhs comes from v2 and the targets
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      rhs_base[e] = -r_z[e];
      if (i < nz) {
        float ctv = 0.f;
        for (int l = 0; l < nc; ++l) ctv += Cm[l * ld + i] * v2[l];
        xr[i] = rhs_base[e] + ctv + (0.f / bl[e] - z[e].nl) - (0.f / bu[e] - z[e].nu);
      }
    }
    __syncthreads();

    // ---- factor + predictor solve (+ Woodbury set) ----
    ipd::chol_blocked<NT>(S, nz, ld, wscr);
    ipd::tri_solve_warps<NW>(S, ld, X, ld, nz, ks + 1, warp);  // xr: warp ks % NW == 0
    if (ks > 0) {
      __syncthreads();
      // T = Cs Xs' (lower triangle) and u = Cs x_aff
      for (int idx = t; idx < ks * ks + ks; idx += NT) {
        if (idx < ks * ks) {
          const int r = idx / ks, q = idx % ks;
          if (q <= r) {
            const float* cs = Cm + sidx[r] * ld;
            const float* xs = X + q * ld;
            float s = 0.f;
            for (int j = 0; j < nz; ++j) s += cs[j] * xs[j];
            T[idx] = s;
          }
        } else {
          const int r = idx - ks * ks;
          const float* cs = Cm + sidx[r] * ld;
          float s = 0.f;
          for (int j = 0; j < nz; ++j) s += cs[j] * xr[j];
          u[r] = s;
        }
      }
      __syncthreads();
      if (warp == 0) {
        ipd::wood_factor_warp(T, vds, ks, eps);
        ipd::wood_apply_warp(T, Cm, ld, sidx, X, ld, xr, u, nz, ks, true);
      }
    }
    if (warp == 0) ipd::zero_unless_finite_warp(xr, nz);
    __syncthreads();

    // ---- recover the affine direction ----
    auto step_piece = [&](int e, float dz_, float dw_, float dsl_, float dsu_, float dll_,
                          float dlu_, float dgl_, float dgu_, float dnl_, float dnu_) {
      const int i = t + e * NT;
      const CState& K = c[e];
      float m = CUDART_INF_F;
      if (i < nc) {
        m = fminf(m, fminf(max_step(K.sl, dsl_), max_step(K.su, dsu_)));
        m = fminf(m, fminf(max_step(tl[e], dw_ + dsl_), max_step(tu[e], dsu_ - dw_)));
        m = fminf(m, fminf(max_step(K.ll, dll_), max_step(K.lu, dlu_)));
        m = fminf(m, fminf(max_step(K.gl, dgl_), max_step(K.gu, dgu_)));
      }
      if (i < nz) {
        m = fminf(m, fminf(max_step(z[e].nl, dnl_), max_step(z[e].nu, dnu_)));
        m = fminf(m, fminf(max_step(bl[e], dz_), max_step(bu[e], -dz_)));
      }
      return m;
    };
    auto compl_part = [&](int e, float w_, float dz_, float sl_, float su_, float ll_,
                          float lu_, float gl_, float gu_, float nl_, float nu_, float* acc2) {
      const int i = t + e * NT;
      const ZState& Z = z[e];
      const CState& K = c[e];
      if (i < nz) acc2[0] += (dz_ - Z.lb) * nl_ + (Z.ub - dz_) * nu_;
      if (i < nc)
        acc2[1] += (w_ + sl_ - K.lh) * ll_ + (K.uh + su_ - w_) * lu_ + sl_ * gl_ + su_ * gu_;
    };
    auto c_times = [&](int i, const float* x) {  // (C x)_i
      const float* row = Cm + i * ld;
      float s = 0.f;
      for (int j = 0; j < nz; ++j) s += row[j] * x[j];
      return s;
    };

    float adz[EPT], adw[EPT], adsl[EPT], adsu[EPT], adll[EPT], adlu[EPT], adgl[EPT],
        adgu[EPT], adnl[EPT], adnu[EPT];
    float m_aff = CUDART_INF_F;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      const CState& K = c[e];
      const ZState& Z = z[e];
      adz[e] = i < nz ? xr[i] : 0.f;
      adw[e] = i < nc ? c_times(i, xr) : 0.f;
      adsl[e] = (b_l0[e] - ql[e] * adw[e]) / d_l[e];
      adsu[e] = (b_u0[e] + qu[e] * adw[e]) / d_u[e];
      adll[e] = a_l0[e] - ql[e] * (adw[e] + adsl[e]);
      adlu[e] = a_u0[e] - qu[e] * (adsu[e] - adw[e]);
      adgl[e] = (0.f - K.gl * K.sl) / K.sl - pl[e] * adsl[e];
      adgu[e] = (0.f - K.gu * K.su) / K.su - pu[e] * adsu[e];
      adnl[e] = (0.f - Z.nl * bl[e]) / bl[e] - rbl[e] * adz[e];
      adnu[e] = (0.f - Z.nu * bu[e]) / bu[e] + rbu[e] * adz[e];
      m_aff = fminf(m_aff, step_piece(e, adz[e], adw[e], adsl[e], adsu[e], adll[e], adlu[e],
                                      adgl[e], adgu[e], adnl[e], adnu[e]));
    }
    const float alpha_aff = fminf(1.f, 1.f * block_min<NT>(m_aff, red, slot));

    // ---- Mehrotra centering ----
    float pa[2] = {0.f, 0.f};
    {
      const float aa = alpha_aff;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const CState& K = c[e];
        const ZState& Z = z[e];
        compl_part(e, w[e] + aa * adw[e], Z.dz + aa * adz[e], K.sl + aa * adsl[e],
                   K.su + aa * adsu[e], K.ll + aa * adll[e], K.lu + aa * adlu[e],
                   K.gl + aa * adgl[e], K.gu + aa * adgu[e], Z.nl + aa * adnl[e],
                   Z.nu + aa * adnu[e], pa);
      }
    }
    block_sum<NT, 2>(pa, red, slot);
    const float mu_aff = (pa[0] + pa[1]) / n_terms;
    const float ratio = fmaxf(mu_aff, 0.f) / fmaxf(mu_cur, a.d_floor);
    const float sigma = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 1.f);
    const float mu_t = fmaxf(sigma * mu_cur, a.mu_min);

    // ---- corrector ----
    float m_sl[EPT], m_su[EPT], m_bl[EPT], m_bu[EPT], a_l[EPT], a_u[EPT], b_l[EPT], b_u[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      const CState& K = c[e];
      const float m_tl = mu_t - adll[e] * (adw[e] + adsl[e]);
      const float m_tu = mu_t - adlu[e] * (adsu[e] - adw[e]);
      m_sl[e] = mu_t - adgl[e] * adsl[e];
      m_su[e] = mu_t - adgu[e] * adsu[e];
      m_bl[e] = mu_t - adnl[e] * adz[e];
      m_bu[e] = mu_t + adnu[e] * adz[e];
      a_l[e] = m_tl / tl[e] - K.ll;
      a_u[e] = m_tu / tu[e] - K.lu;
      b_l[e] = -r_sl[e] + a_l[e] + m_sl[e] / K.sl - K.gl;
      b_u[e] = -r_su[e] + a_u[e] + m_su[e] / K.su - K.gu;
      if (i < nc) v2[i] = (a_l[e] - ql[e] * b_l[e] / d_l[e]) - (a_u[e] - qu[e] * b_u[e] / d_u[e]);
    }
    __syncthreads();
    // the corrector reuses the factor and the Woodbury set (rows 0..ks-1 of
    // X); row ks is free again since adz was read into registers
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      if (i < nz) {
        float ctv = 0.f;
        for (int l = 0; l < nc; ++l) ctv += Cm[l * ld + i] * v2[l];
        xr[i] = rhs_base[e] + ctv + (m_bl[e] / bl[e] - z[e].nl) - (m_bu[e] / bu[e] - z[e].nu);
      }
    }
    __syncthreads();
    if (warp == 0) {
      ipd::tri_solve_warps<NW>(S, ld, xr, ld, nz, 1, 0);
      if (ks > 0) ipd::wood_apply_warp(T, Cm, ld, sidx, X, ld, xr, u, nz, ks, false);
      ipd::zero_unless_finite_warp(xr, nz);
    }
    __syncthreads();

    float ddz[EPT], dw[EPT], dsl[EPT], dsu[EPT], dll[EPT], dlu[EPT], dgl[EPT], dgu[EPT],
        dnl[EPT], dnu[EPT];
    float m_c = CUDART_INF_F;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = t + e * NT;
      const CState& K = c[e];
      const ZState& Z = z[e];
      ddz[e] = i < nz ? xr[i] : 0.f;
      dw[e] = i < nc ? c_times(i, xr) : 0.f;
      dsl[e] = (b_l[e] - ql[e] * dw[e]) / d_l[e];
      dsu[e] = (b_u[e] + qu[e] * dw[e]) / d_u[e];
      dll[e] = a_l[e] - ql[e] * (dw[e] + dsl[e]);
      dlu[e] = a_u[e] - qu[e] * (dsu[e] - dw[e]);
      dgl[e] = (m_sl[e] - K.gl * K.sl) / K.sl - pl[e] * dsl[e];
      dgu[e] = (m_su[e] - K.gu * K.su) / K.su - pu[e] * dsu[e];
      dnl[e] = (m_bl[e] - Z.nl * bl[e]) / bl[e] - rbl[e] * ddz[e];
      dnu[e] = (m_bu[e] - Z.nu * bu[e]) / bu[e] + rbu[e] * ddz[e];
      m_c = fminf(m_c, step_piece(e, ddz[e], dw[e], dsl[e], dsu[e], dll[e], dlu[e], dgl[e],
                                  dgu[e], dnl[e], dnu[e]));
    }
    const float alpha = fminf(1.f, a.tau * block_min<NT>(m_c, red, slot));

    // ---- update with floors ----
    const bool last = it == a.n_iters - 1;
    float pn[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      ZState& Z = z[e];
      CState& K = c[e];
      Z.dz = Z.dz + alpha * ddz[e];
      K.sl = fmaxf(K.sl + alpha * dsl[e], a.p_floor);
      K.su = fmaxf(K.su + alpha * dsu[e], a.p_floor);
      K.ll = fmaxf(K.ll + alpha * dll[e], a.d_floor);
      K.lu = fmaxf(K.lu + alpha * dlu[e], a.d_floor);
      K.gl = fmaxf(K.gl + alpha * dgl[e], a.d_floor);
      K.gu = fmaxf(K.gu + alpha * dgu[e], a.d_floor);
      Z.nl = fmaxf(Z.nl + alpha * dnl[e], a.d_floor);
      Z.nu = fmaxf(Z.nu + alpha * dnu[e], a.d_floor);
      if (last)
        compl_part(e, w[e] + alpha * dw[e], Z.dz, K.sl, K.su, K.ll, K.lu, K.gl, K.gu, Z.nl,
                   Z.nu, pn);
      if (a.n_tail > 0 && it >= a.n_iters - a.n_tail) Z.dzs = Z.dzs + Z.dz;
    }
    // mu is read only after the phase: the next iteration recomputes its own
    if (last) {
      block_sum<NT, 2>(pn, red, slot);
      mu = fmaxf((pn[0] + pn[1]) / n_terms, a.mu_min);
    }
  }

#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = t + e * NT;
    const size_t zo = size_t(b) * nz + i, co = size_t(b) * nc + i;
    if (i < nz) {
      a.o_dz[zo] = z[e].dz; a.o_nl[zo] = z[e].nl; a.o_nu[zo] = z[e].nu;
      a.o_bdz[zo] = z[e].bdz; a.o_dzs[zo] = z[e].dzs;
    }
    if (i < nc) {
      a.o_sl[co] = c[e].sl; a.o_su[co] = c[e].su; a.o_ll[co] = c[e].ll;
      a.o_lu[co] = c[e].lu; a.o_gl[co] = c[e].gl; a.o_gu[co] = c[e].gu;
    }
  }
  if (t == 0) { a.o_mu[b] = mu; a.o_bm[b] = best_m; }
}

size_t smem_bytes(int nz, int nc, int ks) {
  const int ld = nz | 1;
  return sizeof(float) * (size_t(nz) * ld + nz + size_t(nc) * ld + size_t(ks + 1) * ld +
                          ks * ks + nz + 3 * nc + 2 * ks + RED_WORDS + WSCR_WORDS) +
         sizeof(int) * ks;
}

// The attribute is a ceiling (occupancy follows the bytes of each launch), so
// it is set to SMEM_LIMIT once per instance and device.
template <int EPT, int MINB>
cudaError_t configure(size_t smem) {
  static bool set[64] = {};
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(ip_phase_kernel<EPT, MINB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_LIMIT));
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

struct Instance {
  void (*fn)(PhaseArgs);
  cudaError_t (*configure)(size_t);
};

// nz and nc up to NT take one element per thread and up to 4 blocks per SM;
// up to 2 * NT, two elements per thread and the register file of one block.
Instance pick_kernel(int nz, int nc) {
  if (nz <= NT && nc <= NT) return {ip_phase_kernel<1, 4>, configure<1, 4>};
  return {ip_phase_kernel<2, 1>, configure<2, 1>};
}

}  // namespace

// Launch geometry at (nz, nc, ks): threads per block, dynamic shared bytes per
// block and resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int ip_phase_geometry(int nz, int nc, int ks, int* threads, int* smem,
                                      int* blocks_per_sm) {
  const Instance k = pick_kernel(nz, nc);
  const size_t bytes = smem_bytes(nz, nc, ks);
  cudaError_t err = k.configure(bytes);
  if (err != cudaSuccess) return int(err);
  *threads = NT;
  *smem = int(bytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k.fn, NT, bytes));
}

SDF_NMPC_EXPORT int ip_phase_launch(
    const float* H, const float* C, const float* g, const float* c0, const float* lh,
    const float* uh, const float* z1, const float* z2, const float* lb, const float* ub,
    const float* const* state_in, float* const* state_out, int B, int nz, int nc, int ks,
    int n_iters, int it0, int n_tail, float ratio_cap, float mu_min, float p_floor,
    float d_floor, float tau, cudaStream_t stream) {
  if (nz > 2 * NT || nc > 2 * NT || ks > nc || ks < 0 || B <= 0)
    return int(cudaErrorInvalidValue);
  PhaseArgs a;
  a.H = H; a.C = C; a.g = g; a.c0 = c0; a.lh = lh; a.uh = uh; a.z1 = z1; a.z2 = z2;
  a.lb = lb; a.ub = ub;
  a.dz = state_in[0]; a.sl = state_in[1]; a.su = state_in[2]; a.ll = state_in[3];
  a.lu = state_in[4]; a.gl = state_in[5]; a.gu = state_in[6]; a.nl = state_in[7];
  a.nu = state_in[8]; a.mu = state_in[9]; a.bdz = state_in[10]; a.bm = state_in[11];
  a.dzs = state_in[12];
  a.o_dz = state_out[0]; a.o_sl = state_out[1]; a.o_su = state_out[2]; a.o_ll = state_out[3];
  a.o_lu = state_out[4]; a.o_gl = state_out[5]; a.o_gu = state_out[6]; a.o_nl = state_out[7];
  a.o_nu = state_out[8]; a.o_mu = state_out[9]; a.o_bdz = state_out[10];
  a.o_bm = state_out[11]; a.o_dzs = state_out[12];
  a.nz = nz; a.nc = nc; a.ks = ks; a.n_iters = n_iters; a.it0 = it0; a.n_tail = n_tail;
  a.ratio_cap = ratio_cap; a.mu_min = mu_min; a.p_floor = p_floor; a.d_floor = d_floor;
  a.tau = tau;
  const Instance k = pick_kernel(nz, nc);
  const size_t smem = smem_bytes(nz, nc, ks);
  const cudaError_t err = k.configure(smem);
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  const cudaError_t launched = cudaLaunchKernel(reinterpret_cast<const void*>(k.fn), dim3(B),
                                                dim3(NT), args, smem, stream);
  return int(launched != cudaSuccess ? launched : cudaGetLastError());
}
