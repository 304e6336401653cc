"""Kernel 4: one interior-point PHASE (``ip_phase``) and the fused solve.

Counterpart of sdf_nmpc_tpu/ops/ip_kernel.py ``_ip_phase_kernel`` (:78),
``ip_phase_lanes`` (:431) and ``make_fused_solve`` (:523).  One launch runs
n_iters Mehrotra predictor-corrector iterations of the condensed QP for a
batch of scenarios, with the state in place; ``make_fused_solve`` adds the
cold init, the warm phase (k_s = 0) then the stiff phase (k_s = k_stiff),
the final merit, the best-iterate choice, the tail average and the KKT
residual.

Data (batch-first): H (B, nz, nz), C (B, nc, nz), g, lb, ub (B, nz), c0, lh,
uh, z1, z2 (B, nc); lh/uh already clamped to +-1e8.  State: the 13-tuple
(dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu (B,), best_dz,
best_m (B,), dz_tail_sum).

On CUDA tensors ``ip_phase`` launches ``csrc/ip_phase.cu`` (f32 only, k_s a
multiple of 8 with k_s <= nc, else it raises).  On CPU tensors it runs the
plain version: solver/qp.py's iteration body line by line with
``torch.linalg.cholesky`` / ``cholesky_solve``, in f32 or f64.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

BIG = 1e8  # stand-in for infinite bounds (solver/qp.py)


def ip_consts(dtype, ratio_cap_override=None) -> dict:
    """Floors and caps of the interior point for a dtype (solver/qp.py)."""
    eps = torch.finfo(dtype).eps
    return dict(
        ratio_cap=float(0.1 / eps if ratio_cap_override is None else ratio_cap_override),
        mu_min=32 * eps, p_floor=32 * eps * 1e-2, d_floor=1e-14, tau=0.995,
    )


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _max_step(v, dv):
    """Largest alpha with v + alpha dv > 0, per scenario: (B, n) -> (B,)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return ratio.amin(-1)


def _chol(A):
    """Lower Cholesky factor; a failed factorization gives NaN (as in JAX)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[:, None, None], torch.full_like(L, float("nan")), L)


def _iteration_plain(data, state, k_s, it_idx, in_tail, c):
    H, C, g, c0, lh, uh, z1, z2, lb, ub = data
    dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu, best_dz, best_m, dzs = state
    dtype = dz.dtype
    eps = torch.finfo(dtype).eps
    nc = c0.shape[-1]
    n_terms = 2 * dz.shape[-1] + 4 * nc

    w = c0 + _mv(C, dz)
    tl = torch.maximum(w + sl - lh, 4 * eps * (1.0 + w.abs() + sl))
    tu = torch.maximum(uh + su - w, 4 * eps * (1.0 + w.abs() + su))
    bl = torch.maximum(dz - lb, 4 * eps * (1.0 + dz.abs()))
    bu = torch.maximum(ub - dz, 4 * eps * (1.0 + dz.abs()))

    Hdz = _mv(H, dz)
    r_z = Hdz + g - _mtv(C, lam_l - lam_u) - nu_l + nu_u
    r_sl = z1 + z2 * sl - lam_l - gam_l
    r_su = z1 + z2 * su - lam_u - gam_u

    # best-iterate merit at entry; the gate excludes the zero step
    vl = torch.clamp(lh - w, min=0.0)
    vu = torch.clamp(w - uh, min=0.0)
    m_cur = (0.5 * (dz * Hdz).sum(-1) + (g * dz).sum(-1)
             + (z1 * (vl + vu) + 0.5 * z2 * (vl ** 2 + vu ** 2)).sum(-1))
    better = (m_cur < best_m) & (it_idx > 0)
    best_dz = torch.where(better[:, None], dz, best_dz)
    best_m = torch.where(better, m_cur, best_m)

    ql_raw, qu_raw = lam_l / tl, lam_u / tu
    pl_raw, pu_raw = gam_l / sl, gam_u / su
    ratio_cap = torch.full_like(sl, c["ratio_cap"])
    if k_s > 0:
        eta_raw = (ql_raw * (z2 + pl_raw) / (z2 + ql_raw + pl_raw)
                   + qu_raw * (z2 + pu_raw) / (z2 + qu_raw + pu_raw))
        # top-k_s with ties to the lowest index (lax.top_k ordering)
        sidx = torch.sort(eta_raw, dim=-1, descending=True, stable=True).indices[:, :k_s]
        stiff = torch.zeros_like(sl, dtype=torch.bool).scatter(1, sidx, True)
        Cs = torch.gather(C, 1, sidx[..., None].expand(-1, -1, C.shape[-1]))
        cap = torch.where(stiff, torch.full_like(sl, float("inf")), ratio_cap)
    else:
        cap = ratio_cap
    ql, qu = torch.minimum(ql_raw, cap), torch.minimum(qu_raw, cap)
    pl, pu = torch.minimum(pl_raw, cap), torch.minimum(pu_raw, cap)
    d_l = z2 + ql + pl
    d_u = z2 + qu + pu
    eta = ql * (z2 + pl) / d_l + qu * (z2 + pu) / d_u
    rbl, rbu = nu_l / bl, nu_u / bu
    rb = rbl + rbu
    if k_s > 0:
        d_s = torch.gather(eta, 1, sidx)  # exact (uncapped) stiff coefficients
        eta_mild = torch.where(stiff, torch.zeros_like(eta), eta)
    else:
        eta_mild = eta

    A = H + (C.transpose(-1, -2) * eta_mild[:, None, :]) @ C + torch.diag_embed(rb)
    diagA = torch.diagonal(A, dim1=-2, dim2=-1)
    A = A + torch.diag_embed(10 * eps * (diagA.abs() + 1.0))

    def coeffs(m_tl, m_tu, m_sl, m_su):
        a_l = m_tl / tl - lam_l
        a_u = m_tu / tu - lam_u
        b_l = -r_sl + a_l + m_sl / sl - gam_l
        b_u = -r_su + a_u + m_su / su - gam_u
        return a_l, a_u, b_l, b_u

    def rhs_of(m_tl, m_tu, m_sl, m_su, m_bl, m_bu):
        a_l, a_u, b_l, b_u = coeffs(m_tl, m_tu, m_sl, m_su)
        const_l = a_l - ql * b_l / d_l
        const_u = a_u - qu * b_u / d_u
        return -r_z + _mtv(C, const_l - const_u) + (m_bl / bl - nu_l) - (m_bu / bu - nu_u)

    def recover(ddz, m_tl, m_tu, m_sl, m_su, m_bl, m_bu):
        a_l, a_u, b_l, b_u = coeffs(m_tl, m_tu, m_sl, m_su)
        dw = _mv(C, ddz)
        dsl = (b_l - ql * dw) / d_l
        dsu = (b_u + qu * dw) / d_u
        dlam_l = a_l - ql * (dw + dsl)
        dlam_u = a_u - qu * (dsu - dw)
        dgam_l = (m_sl - gam_l * sl) / sl - pl * dsl
        dgam_u = (m_su - gam_u * su) / su - pu * dsu
        dnu_l = (m_bl - nu_l * bl) / bl - rbl * ddz
        dnu_u = (m_bu - nu_u * bu) / bu + rbu * ddz
        return ddz, dw, dsl, dsu, dlam_l, dlam_u, dgam_l, dgam_u, dnu_l, dnu_u

    zc, zz = torch.zeros_like(sl), torch.zeros_like(dz)
    aff_t = (zc, zc, zc, zc, zz, zz)
    rhs_aff = rhs_of(*aff_t)

    # one factor + multi-solve for [rhs_aff; Cs]; the corrector reuses it
    L = _chol(A)
    solve = lambda R: torch.cholesky_solve(R.transpose(-1, -2), L).transpose(-1, -2)
    RHS1 = rhs_aff[:, None, :]
    if k_s > 0:
        RHS1 = torch.cat([RHS1, Cs], dim=1)
    X1 = solve(RHS1)
    if k_s > 0:
        Xs = X1[:, 1:]
        d_s_inv = torch.clamp(1.0 / torch.clamp(d_s, min=1e-30), max=1e30)
        T = Cs @ Xs.transpose(-1, -2) + torch.diag_embed(d_s_inv)
        diagT = torch.diagonal(T, dim1=-2, dim2=-1)
        T = T + torch.diag_embed(10 * eps * (diagT.abs() + 1e-30))
        Lt = _chol(T)

        def woodbury(x):
            y = torch.cholesky_solve(_mv(Cs, x)[..., None], Lt)[..., 0]
            return x - _mtv(Xs, y)
    else:
        woodbury = lambda x: x

    def finish(x_raw):
        x = woodbury(x_raw)
        ok = torch.isfinite(x).all(-1, keepdim=True)
        return torch.where(ok, x, torch.zeros_like(x))

    def step_len(dirn, frac):
        ddz, dw, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu = dirn
        m = torch.minimum(
            torch.minimum(
                torch.minimum(_max_step(sl, dsl), _max_step(su, dsu)),
                torch.minimum(_max_step(tl, dw + dsl), _max_step(tu, dsu - dw)),
            ),
            torch.minimum(
                torch.minimum(
                    torch.minimum(_max_step(lam_l, dll), _max_step(lam_u, dlu)),
                    torch.minimum(_max_step(gam_l, dgl), _max_step(gam_u, dgu)),
                ),
                torch.minimum(
                    torch.minimum(_max_step(nu_l, dnl), _max_step(nu_u, dnu)),
                    torch.minimum(_max_step(bl, ddz), _max_step(bu, -ddz)),
                ),
            ),
        )
        return torch.clamp(frac * m, max=1.0)

    def compl(w_, dz_, sl_, su_, ll_, lu_, gl_, gu_, nl_, nu__):
        total = ((dz_ - lb) * nl_).sum(-1) + ((ub - dz_) * nu__).sum(-1)
        total = total + (((w_ + sl_ - lh) * ll_).sum(-1) + ((uh + su_ - w_) * lu_).sum(-1)
                         + (sl_ * gl_).sum(-1) + (su_ * gu_).sum(-1))
        return total / n_terms

    aff = recover(finish(X1[:, 0]), *aff_t)
    alpha_aff = step_len(aff, 1.0)[:, None]
    adz, adw, adsl, adsu, adll, adlu, adgl, adgu, adnl, adnu = aff
    mu_cur = compl(w, dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u)
    a = alpha_aff
    mu_aff = compl(w + a * adw, dz + a * adz, sl + a * adsl, su + a * adsu,
                   lam_l + a * adll, lam_u + a * adlu, gam_l + a * adgl, gam_u + a * adgu,
                   nu_l + a * adnl, nu_u + a * adnu)
    sigma = torch.clamp((torch.clamp(mu_aff, min=0.0)
                         / torch.clamp(mu_cur, min=c["d_floor"])) ** 3, 1e-4, 1.0)
    mu_t = torch.clamp(sigma * mu_cur, min=c["mu_min"])[:, None]

    corr_t = (mu_t - adll * (adw + adsl), mu_t - adlu * (adsu - adw),
              mu_t - adgl * adsl, mu_t - adgu * adsu,
              mu_t - adnl * adz, mu_t + adnu * adz)
    corr = recover(finish(solve(rhs_of(*corr_t)[:, None, :])[:, 0]), *corr_t)
    alpha = step_len(corr, c["tau"])[:, None]
    ddz, dw, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu = corr

    dz = dz + alpha * ddz
    sl = torch.clamp(sl + alpha * dsl, min=c["p_floor"])
    su = torch.clamp(su + alpha * dsu, min=c["p_floor"])
    lam_l = torch.clamp(lam_l + alpha * dll, min=c["d_floor"])
    lam_u = torch.clamp(lam_u + alpha * dlu, min=c["d_floor"])
    gam_l = torch.clamp(gam_l + alpha * dgl, min=c["d_floor"])
    gam_u = torch.clamp(gam_u + alpha * dgu, min=c["d_floor"])
    nu_l = torch.clamp(nu_l + alpha * dnl, min=c["d_floor"])
    nu_u = torch.clamp(nu_u + alpha * dnu, min=c["d_floor"])
    mu = torch.clamp(compl(w + alpha * dw, dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u),
                     min=c["mu_min"])
    if in_tail:
        dzs = dzs + dz
    return (dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu, best_dz, best_m, dzs)


def ip_phase_plain(data, state, k_s, n_iters, it0, consts, n_tail=0):
    """n_iters iterations of solver/qp.py's body; k_s is clamped to nc."""
    k_s = min(k_s, data[3].shape[-1])
    for i in range(n_iters):
        state = _iteration_plain(data, state, k_s, it0 + i,
                                 n_tail > 0 and i >= n_iters - n_tail, consts)
    return state


def _ip_phase_cuda(data, state, k_s, n_iters, it0, consts, n_tail=0):
    H, C = data[0], data[1]
    B, nz = H.shape[0], H.shape[-1]
    nc = C.shape[1]
    if k_s % 8 != 0 or k_s > nc:
        raise NotImplementedError(
            f"ip_phase kernel needs k_stiff % 8 == 0 and k_stiff <= nc, got k={k_s}, nc={nc} "
            "(the composed QP path is queued in ROADMAP.md)")
    if nz > 256 or nc > 256:
        raise ValueError(f"ip_phase kernel takes nz, nc <= 256, got {nz}, {nc}")
    _lib.require_cuda_f32("ip_phase", *data, *state)
    shapes = [(B, nz, nz), (B, nc, nz), (B, nz), (B, nc), (B, nc), (B, nc), (B, nc),
              (B, nc), (B, nz), (B, nz)]
    shapes += [(B, nz)] + [(B, nc)] * 6 + [(B, nz), (B, nz), (B,), (B, nz), (B,), (B, nz)]
    for i, (t, s) in enumerate(zip(tuple(data) + tuple(state), shapes)):
        _lib.require_shape(f"ip_phase argument {i}", t, s)
    out = tuple(torch.empty_like(s) for s in state)
    ptrs_in = (ctypes.c_void_p * 13)(*[s.data_ptr() for s in state])
    ptrs_out = (ctypes.c_void_p * 13)(*[s.data_ptr() for s in out])
    err = _lib.library().ip_phase_launch(
        *[t.data_ptr() for t in data],
        ctypes.cast(ptrs_in, ctypes.c_void_p), ctypes.cast(ptrs_out, ctypes.c_void_p),
        B, nz, nc, k_s, n_iters, it0, n_tail,
        consts["ratio_cap"], consts["mu_min"], consts["p_floor"], consts["d_floor"],
        consts["tau"], _lib.stream_ptr())
    _lib.check(err, "ip_phase")
    _lib.launch_counts["ip_phase"] += 1
    return out


def ip_phase(data, state, k_s, n_iters, it0, consts, n_tail=0):
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if data[0].is_cuda:
        return _ip_phase_cuda(data, state, k_s, n_iters, it0, consts, n_tail)
    return ip_phase_plain(data, state, k_s, n_iters, it0, consts, n_tail)


def make_fused_solve(iters, n_warm, k_stiff, mu0, box_margin, ratio_cap_override=None):
    """run(H, g, C, c0, lh, uh, z1, z2, lb, ub) -> (dz, kkt, mu, sl, su, lam_l,
    lam_u, gam_l, gam_u, nu_l, nu_u) for one static configuration."""

    def run(H, g, C, c0, lh, uh, z1, z2, lb, ub):
        consts = ip_consts(g.dtype, ratio_cap_override)
        B, nz = g.shape
        lh_c = torch.clamp(lh, min=-BIG)
        uh_c = torch.clamp(uh, max=BIG)

        # cold init (solver/qp.py, warm_duals=None)
        width = ub - lb
        dz = torch.clamp(torch.zeros_like(lb), lb + box_margin * (1 + width),
                         ub - box_margin * (1 + width))
        w0 = c0 + _mv(C, dz)
        sl = torch.clamp(lh_c - w0, min=0.0) + 0.1
        su = torch.clamp(w0 - uh_c, min=0.0) + 0.1
        state = (dz, sl, su, mu0 / (w0 + sl - lh_c), mu0 / (uh_c + su - w0), mu0 / sl,
                 mu0 / su, mu0 / (dz - lb), mu0 / (ub - dz),
                 torch.full((B,), mu0, dtype=g.dtype, device=g.device), dz.clone(),
                 torch.full((B,), float("inf"), dtype=g.dtype, device=g.device),
                 torch.zeros_like(dz))
        data = (H, C, g, c0, lh_c, uh_c, z1, z2, lb, ub)
        data = tuple(t.contiguous() for t in data)
        state = tuple(t.contiguous() for t in state)

        # tail-averaged-iterate window: the last min(8, n_stiff) stiff
        # iterates, once the stiff phase is long enough for an average
        n_stiff = iters - n_warm
        n_tail = min(8, n_stiff) if n_stiff >= 4 else 0
        if n_warm > 0:
            state = ip_phase(data, state, 0, n_warm, 0, consts)
        if n_stiff > 0:
            state = ip_phase(data, state, k_stiff, n_stiff, n_warm, consts, n_tail)
        dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu, best_dz, best_m, dzs = state

        def merit(z):
            wz = c0 + _mv(C, z)
            vl = torch.clamp(lh_c - wz, min=0.0)
            vu = torch.clamp(wz - uh_c, min=0.0)
            return (0.5 * (z * _mv(H, z)).sum(-1) + (g * z).sum(-1)
                    + (z1 * (vl + vu) + 0.5 * z2 * (vl ** 2 + vu ** 2)).sum(-1))

        m_fin = merit(dz)
        dz = torch.where((m_fin < best_m)[:, None], dz, best_dz)
        if n_tail > 0:
            dz_avg = dzs / n_tail
            take_avg = merit(dz_avg) < torch.minimum(best_m, m_fin)
            dz = torch.where(take_avg[:, None], dz_avg, dz)

        lam_l_r = torch.minimum(lam_l, z1 + z2 * sl)
        lam_u_r = torch.minimum(lam_u, z1 + z2 * su)
        grad = _mv(H, dz) + g - _mtv(C, lam_l_r - lam_u_r)
        kkt = (dz - torch.minimum(torch.maximum(dz - grad, lb), ub)).abs().amax(-1)
        return dz, kkt, mu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u

    return run
