// One phase (n_iters Mehrotra predictor-corrector iterations) of the
// condensed-QP interior point, for a batch of independent scenarios.
//
// Replaces: sdf_nmpc_tpu/ops/ip_kernel.py _ip_phase_kernel (:78), with the
// Cholesky / tri-solve / Woodbury helpers of ops/qp_kernels.py (:72, :138,
// :284) inside (qp_device.cuh).  Semantics follow that kernel and
// solver/qp.py line by line: noise-aware gap floors, KKT residuals, the
// best-iterate merit at body entry (gated off at global iteration 0), the
// mild-row ratio cap, top-k_s stiff rows by argmax-and-mask on the RAW eta
// (ties to the lowest index), the Newton matrix A = H + C' diag(eta_mild) C
// + diag(rb) with a 10 eps (|d| + 1) diagonal jitter, the predictor rhs
// riding as row k_s of the (k_s + 1)-RHS tri-solve, T = Cs Xs' + diag(1/eta_s)
// jittered and factored, non-finite directions zeroed per scenario, tau =
// 0.995, sigma = clip((mu_aff / mu)^3, 1e-4, 1), the mu_min / p_floor /
// d_floor floors, and the tail sum of the last n_tail iterates.
//
// Bound on this card: operations.  Per iteration and scenario the work is
// ~1 M flops (A build ~3 nz^2 nc / 2, Cholesky nz^3 / 3, the (k_s+1)- and
// 1-RHS sweeps), against ~0.45 GB read once per phase at B=8192.  What
// holds this first kernel far above that bound is the sequential chain of
// the factorization and solves: two __syncthreads per column step, with
// few threads busy in each.
//
// Design: one thread block per scenario, NT=256 threads.  H, C, the Newton
// matrix A (factored in place), the multi-RHS block [Cs; rhs] and T all stay
// in shared memory for all n_iters iterations (78 KB at nz=80, nc=63,
// k_s=8: two blocks per SM), so H and C are read from device memory once
// per phase.  Thread t owns element t of every nz-vector and row t of every
// nc-vector in registers (nz, nc <= NT); matrix-vector products go through
// shared copies of the vectors.  A simple kernel that is right comes first:
// batching several scenarios per block, warp-level factorization steps and
// a left-looking blocked Cholesky are later levers.

#include "common.cuh"
#include "qp_device.cuh"

namespace {

constexpr int NT = 256;

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

__global__ void __launch_bounds__(NT) ip_phase_kernel(PhaseArgs a) {
  extern __shared__ float smem[];
  const int nz = a.nz, nc = a.nc, ks = a.ks;
  const int b = blockIdx.x, t = threadIdx.x;
  const bool hz = t < nz, hc = t < nc;
  const float eps = 1.1920928955078125e-07f;  // f32 machine epsilon
  const float n_terms = float(2 * nz + 4 * nc);

  float* sH = smem;                 // nz*nz
  float* sA = sH + nz * nz;         // nz*nz
  float* sC = sA + nz * nz;         // nc*nz
  float* sX = sC + nc * nz;         // (ks+1)*nz: [Cs' solves; rhs]
  float* sCs = sX + (ks + 1) * nz;  // ks*nz
  float* sT = sCs + ks * nz;        // ks*ks
  float* vz = sT + ks * ks;         // nz: shared z-vector
  float* vc = vz + nz;              // nc: shared c-vector
  float* vu = vc + nc;              // ks: Woodbury scratch
  float* vds = vu + ks;             // ks: exact stiff coefficients
  float* red = vds + ks;            // 2*NT/32 reduction scratch
  int* sidx = reinterpret_cast<int*>(red + 2 * (NT / 32));  // ks

  const size_t zoff = size_t(b) * nz, coff = size_t(b) * nc;
  for (int i = t; i < nz * nz; i += NT) sH[i] = a.H[size_t(b) * nz * nz + i];
  for (int i = t; i < nc * nz; i += NT) sC[i] = a.C[size_t(b) * nc * nz + i];

  float g = 0.f, lb = 0.f, ub = 0.f, dz = 0.f, nl = 0.f, nu = 0.f, bdz = 0.f, dzs = 0.f;
  if (hz) {
    g = a.g[zoff + t]; lb = a.lb[zoff + t]; ub = a.ub[zoff + t];
    dz = a.dz[zoff + t]; nl = a.nl[zoff + t]; nu = a.nu[zoff + t];
    bdz = a.bdz[zoff + t]; dzs = a.dzs[zoff + t];
  }
  float c0 = 0.f, lh = 0.f, uh = 0.f, z1 = 0.f, z2 = 0.f;
  float sl = 1.f, su = 1.f, ll = 0.f, lu = 0.f, gl = 0.f, gu = 0.f;
  if (hc) {
    c0 = a.c0[coff + t]; lh = a.lh[coff + t]; uh = a.uh[coff + t];
    z1 = a.z1[coff + t]; z2 = a.z2[coff + t];
    sl = a.sl[coff + t]; su = a.su[coff + t]; ll = a.ll[coff + t]; lu = a.lu[coff + t];
    gl = a.gl[coff + t]; gu = a.gu[coff + t];
  }
  float best_m = a.bm[b];
  float mu = a.mu[b];
  __syncthreads();

  for (int it = 0; it < a.n_iters; ++it) {
    // ---- gaps with cancellation-noise floors ----
    if (hz) vz[t] = dz;
    __syncthreads();
    float w = 0.f;
    if (hc) {
      float s = 0.f;
      for (int j = 0; j < nz; ++j) s += sC[t * nz + j] * vz[j];
      w = c0 + s;
    }
    const float tl = fmaxf(w + sl - lh, 4.f * eps * (1.f + fabsf(w) + sl));
    const float tu = fmaxf(uh + su - w, 4.f * eps * (1.f + fabsf(w) + su));
    const float bl = fmaxf(dz - lb, 4.f * eps * (1.f + fabsf(dz)));
    const float bu = fmaxf(ub - dz, 4.f * eps * (1.f + fabsf(dz)));

    // ---- KKT stationarity residuals ----
    float Hdz = 0.f;
    if (hz)
      for (int j = 0; j < nz; ++j) Hdz += sH[t * nz + j] * vz[j];
    if (hc) vc[t] = ll - lu;
    __syncthreads();
    float r_z = 0.f;
    if (hz) {
      float ctv = 0.f;
      for (int i = 0; i < nc; ++i) ctv += sC[i * nz + t] * vc[i];
      r_z = Hdz + g - ctv - nl + nu;
    }
    const float r_sl = z1 + z2 * sl - ll - gl;
    const float r_su = z1 + z2 * su - lu - gu;

    // ---- best-iterate merit at entry (gate excludes the zero step) ----
    {
      const float vl = fmaxf(lh - w, 0.f), vu_ = fmaxf(w - uh, 0.f);
      float2 part = make_float2(hz ? dz * Hdz : 0.f, hz ? g * dz : 0.f);
      const float pen = hc ? z1 * (vl + vu_) + 0.5f * z2 * (vl * vl + vu_ * vu_) : 0.f;
      const float2 s2 = block_sum2<NT>(part, red);
      const float s3 = block_sum<NT>(pen, red);
      const float m_cur = 0.5f * s2.x + s2.y + s3;
      if (m_cur < best_m && (a.it0 + it) > 0) {
        bdz = dz;
        best_m = m_cur;
      }
    }

    // ---- barrier ratios + stiff-row split ----
    const float ql_raw = hc ? ll / tl : 0.f, qu_raw = hc ? lu / tu : 0.f;
    const float pl_raw = hc ? gl / sl : 0.f, pu_raw = hc ? gu / su : 0.f;
    int my_s = -1;  // position of this row among the stiff rows, or -1
    if (ks > 0) {
      const float dl0 = z2 + ql_raw + pl_raw, du0 = z2 + qu_raw + pu_raw;
      float masked = hc ? ql_raw * (z2 + pl_raw) / dl0 + qu_raw * (z2 + pu_raw) / du0
                        : -CUDART_INF_F;
      for (int s = 0; s < ks; ++s) {
        const int idx = block_argmax<NT>(masked, t, red);
        if (t == idx) { my_s = s; masked = -CUDART_INF_F; }
        if (t == 0) sidx[s] = idx;
      }
    }
    const float cap = my_s >= 0 ? CUDART_INF_F : a.ratio_cap;
    const float ql = fminf(ql_raw, cap), qu = fminf(qu_raw, cap);
    const float pl = fminf(pl_raw, cap), pu = fminf(pu_raw, cap);
    const float d_l = z2 + ql + pl, d_u = z2 + qu + pu;
    const float eta = hc ? ql * (z2 + pl) / d_l + qu * (z2 + pu) / d_u : 0.f;
    const float rbl = hz ? nl / bl : 0.f, rbu = hz ? nu / bu : 0.f;
    const float rb = rbl + rbu;
    if (my_s >= 0) vds[my_s] = eta;  // exact (uncapped) stiff coefficient
    if (hc) vc[t] = my_s >= 0 ? 0.f : eta;  // eta_mild
    if (hz) vz[t] = rb;
    __syncthreads();

    // ---- Newton matrix, lower triangle: H + C' diag(eta_mild) C + diag(rb) ----
    {
      const int ty = t / 16, tx = t % 16;
      for (int r = ty; r < nz; r += NT / 16) {
        for (int j = tx; j <= r; j += 16) {
          float s = 0.f;
          for (int i = 0; i < nc; ++i) s += (sC[i * nz + r] * vc[i]) * sC[i * nz + j];
          float v = sH[r * nz + j] + s;
          if (r == j) {
            v = v + vz[j];
            v = v + 10.f * eps * (fabsf(v) + 1.f);
          }
          sA[r * nz + j] = v;
        }
      }
    }
    if (ks > 0)
      for (int i = t; i < ks * nz; i += NT) sCs[i] = sC[sidx[i / nz] * nz + i % nz];

    // ---- predictor rhs (targets = 0) ----
    const float a_l0 = 0.f / tl - ll, a_u0 = 0.f / tu - lu;
    const float b_l0 = -r_sl + a_l0 + 0.f / sl - gl, b_u0 = -r_su + a_u0 + 0.f / su - gu;
    __syncthreads();  // vc (eta_mild) reads done
    if (hc) vc[t] = (a_l0 - ql * b_l0 / d_l) - (a_u0 - qu * b_u0 / d_u);
    __syncthreads();
    float rhs_aff = 0.f;
    if (hz) {
      float ctv = 0.f;
      for (int i = 0; i < nc; ++i) ctv += sC[i * nz + t] * vc[i];
      rhs_aff = -r_z + ctv + (0.f / bl - nl) - (0.f / bu - nu);
    }

    // ---- factor + predictor solve (+ Woodbury set) ----
    chol_block<NT>(sA, nz);
    float* x_aff = sX + ks * nz;
    for (int i = t; i < ks * nz; i += NT) sX[i] = sCs[i];
    if (hz) x_aff[t] = rhs_aff;
    __syncthreads();
    tri_solve_block<NT>(sA, sX, nz, ks + 1);
    if (ks > 0) {
      for (int idx = t; idx < ks * ks; idx += NT) {
        const int r = idx / ks, c = idx % ks;
        float s = 0.f;
        for (int j = 0; j < nz; ++j) s += sCs[r * nz + j] * sX[c * nz + j];
        sT[idx] = s;
      }
      __syncthreads();
      if (t == 0) {
        for (int s = 0; s < ks; ++s) {
          const float dsi = fminf(1.f / fmaxf(vds[s], 1e-30f), 1e30f);
          const float d = sT[s * ks + s] + dsi;
          sT[s * ks + s] = d + 10.f * eps * (fabsf(d) + 1e-30f);
        }
        chol_serial(sT, ks);
      }
      __syncthreads();
      wood_correct<NT>(sT, sCs, sX, x_aff, vu, nz, ks);
    }
    float adz = hz ? x_aff[t] : 0.f;
    if (!block_all<NT>(!hz || isfinite(adz), red)) adz = 0.f;

    // ---- recover the affine direction ----
    if (hz) vz[t] = adz;
    __syncthreads();
    float adw = 0.f;
    if (hc)
      for (int j = 0; j < nz; ++j) adw += sC[t * nz + j] * vz[j];
    const float adsl = (b_l0 - ql * adw) / d_l;
    const float adsu = (b_u0 + qu * adw) / d_u;
    const float adll = a_l0 - ql * (adw + adsl);
    const float adlu = a_u0 - qu * (adsu - adw);
    const float adgl = (0.f - gl * sl) / sl - pl * adsl;
    const float adgu = (0.f - gu * su) / su - pu * adsu;
    const float adnl = (0.f - nl * bl) / bl - rbl * adz;
    const float adnu = (0.f - nu * bu) / bu + rbu * adz;

    auto step_piece = [&](float dz_, float dw_, float dsl_, float dsu_, float dll_,
                          float dlu_, float dgl_, float dgu_, float dnl_, float dnu_) {
      float m = CUDART_INF_F;
      if (hc) {
        m = fminf(m, fminf(max_step(sl, dsl_), max_step(su, dsu_)));
        m = fminf(m, fminf(max_step(tl, dw_ + dsl_), max_step(tu, dsu_ - dw_)));
        m = fminf(m, fminf(max_step(ll, dll_), max_step(lu, dlu_)));
        m = fminf(m, fminf(max_step(gl, dgl_), max_step(gu, dgu_)));
      }
      if (hz) {
        m = fminf(m, fminf(max_step(nl, dnl_), max_step(nu, dnu_)));
        m = fminf(m, fminf(max_step(bl, dz_), max_step(bu, -dz_)));
      }
      return m;
    };
    const float alpha_aff =
        fminf(1.f, 1.f * block_min<NT>(step_piece(adz, adw, adsl, adsu, adll, adlu, adgl,
                                                   adgu, adnl, adnu), red));

    // ---- Mehrotra centering ----
    auto compl_part = [&](float w_, float dz_, float sl_, float su_, float ll_, float lu_,
                          float gl_, float gu_, float nl_, float nu_) {
      float zpart = hz ? (dz_ - lb) * nl_ + (ub - dz_) * nu_ : 0.f;
      float cpart = hc ? (w_ + sl_ - lh) * ll_ + (uh + su_ - w_) * lu_ + sl_ * gl_ + su_ * gu_
                       : 0.f;
      return make_float2(zpart, cpart);
    };
    const float2 pc = block_sum2<NT>(compl_part(w, dz, sl, su, ll, lu, gl, gu, nl, nu), red);
    const float mu_cur = (pc.x + pc.y) / n_terms;
    const float aa = alpha_aff;
    const float2 pa = block_sum2<NT>(
        compl_part(w + aa * adw, dz + aa * adz, sl + aa * adsl, su + aa * adsu, ll + aa * adll,
                   lu + aa * adlu, gl + aa * adgl, gu + aa * adgu, nl + aa * adnl,
                   nu + aa * adnu),
        red);
    const float mu_aff = (pa.x + pa.y) / n_terms;
    const float ratio = fmaxf(mu_aff, 0.f) / fmaxf(mu_cur, a.d_floor);
    const float sigma = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 1.f);
    const float mu_t = fmaxf(sigma * mu_cur, a.mu_min);

    // ---- corrector ----
    const float m_tl = mu_t - adll * (adw + adsl);
    const float m_tu = mu_t - adlu * (adsu - adw);
    const float m_sl = mu_t - adgl * adsl;
    const float m_su = mu_t - adgu * adsu;
    const float m_bl = mu_t - adnl * adz;
    const float m_bu = mu_t + adnu * adz;
    const float a_l = m_tl / tl - ll, a_u = m_tu / tu - lu;
    const float b_l = -r_sl + a_l + m_sl / sl - gl, b_u = -r_su + a_u + m_su / su - gu;
    if (hc) vc[t] = (a_l - ql * b_l / d_l) - (a_u - qu * b_u / d_u);
    __syncthreads();
    // the corrector reuses the factor and the Woodbury set (rows 0..ks-1 of
    // sX); row ks is free again since adz was read into registers
    float* x_c = x_aff;
    if (hz) {
      float ctv = 0.f;
      for (int i = 0; i < nc; ++i) ctv += sC[i * nz + t] * vc[i];
      x_c[t] = -r_z + ctv + (m_bl / bl - nl) - (m_bu / bu - nu);
    }
    __syncthreads();
    tri_solve_block<NT>(sA, x_c, nz, 1);
    if (ks > 0) wood_correct<NT>(sT, sCs, sX, x_c, vu, nz, ks);
    float ddz = hz ? x_c[t] : 0.f;
    if (!block_all<NT>(!hz || isfinite(ddz), red)) ddz = 0.f;

    if (hz) vz[t] = ddz;
    __syncthreads();
    float dw = 0.f;
    if (hc)
      for (int j = 0; j < nz; ++j) dw += sC[t * nz + j] * vz[j];
    const float dsl = (b_l - ql * dw) / d_l;
    const float dsu = (b_u + qu * dw) / d_u;
    const float dll = a_l - ql * (dw + dsl);
    const float dlu = a_u - qu * (dsu - dw);
    const float dgl = (m_sl - gl * sl) / sl - pl * dsl;
    const float dgu = (m_su - gu * su) / su - pu * dsu;
    const float dnl = (m_bl - nl * bl) / bl - rbl * ddz;
    const float dnu = (m_bu - nu * bu) / bu + rbu * ddz;
    const float alpha = fminf(
        1.f, a.tau * block_min<NT>(step_piece(ddz, dw, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu),
                                   red));

    // ---- update with floors ----
    dz = dz + alpha * ddz;
    sl = fmaxf(sl + alpha * dsl, a.p_floor);
    su = fmaxf(su + alpha * dsu, a.p_floor);
    ll = fmaxf(ll + alpha * dll, a.d_floor);
    lu = fmaxf(lu + alpha * dlu, a.d_floor);
    gl = fmaxf(gl + alpha * dgl, a.d_floor);
    gu = fmaxf(gu + alpha * dgu, a.d_floor);
    nl = fmaxf(nl + alpha * dnl, a.d_floor);
    nu = fmaxf(nu + alpha * dnu, a.d_floor);
    const float2 pn =
        block_sum2<NT>(compl_part(w + alpha * dw, dz, sl, su, ll, lu, gl, gu, nl, nu), red);
    mu = fmaxf((pn.x + pn.y) / n_terms, a.mu_min);
    if (a.n_tail > 0 && it >= a.n_iters - a.n_tail) dzs = dzs + dz;
    __syncthreads();
  }

  if (hz) {
    a.o_dz[zoff + t] = dz; a.o_nl[zoff + t] = nl; a.o_nu[zoff + t] = nu;
    a.o_bdz[zoff + t] = bdz; a.o_dzs[zoff + t] = dzs;
  }
  if (hc) {
    a.o_sl[coff + t] = sl; a.o_su[coff + t] = su; a.o_ll[coff + t] = ll;
    a.o_lu[coff + t] = lu; a.o_gl[coff + t] = gl; a.o_gu[coff + t] = gu;
  }
  if (t == 0) { a.o_mu[b] = mu; a.o_bm[b] = best_m; }
}

}  // namespace

SDF_NMPC_EXPORT size_t ip_phase_smem_bytes(int nz, int nc, int ks) {
  return sizeof(float) * (2 * nz * nz + nc * nz + (ks + 1) * nz + ks * nz + ks * ks + nz +
                          nc + 2 * ks + 2 * (NT / 32)) +
         sizeof(int) * ks;
}

SDF_NMPC_EXPORT int ip_phase_launch(
    const float* H, const float* C, const float* g, const float* c0, const float* lh,
    const float* uh, const float* z1, const float* z2, const float* lb, const float* ub,
    const float* const* state_in, float* const* state_out, int B, int nz, int nc, int ks,
    int n_iters, int it0, int n_tail, float ratio_cap, float mu_min, float p_floor,
    float d_floor, float tau, cudaStream_t stream) {
  if (nz > NT || nc > NT || ks > nc || B <= 0) return int(cudaErrorInvalidValue);
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
  const size_t smem = ip_phase_smem_bytes(nz, nc, ks);
  cudaError_t err = cudaFuncSetAttribute(
      ip_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  ip_phase_kernel<<<B, NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}
