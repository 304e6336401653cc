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
multiple of 8 with k_s <= nc, nz and nc at most 256, else it raises; its
blocked factorization and warp-level solves are in ``csrc/ip_dense.cuh``).  On CPU tensors it runs the
plain version: solver/qp.py's iteration body line by line
(``ip_iteration``) with ``torch.linalg.cholesky`` / ``cholesky_solve``, in
f32 or f64.

The start (``ip_init``, cold or from warm duals), the iteration body
(``ip_iteration``) and the finish (``ip_finish``) are shared with the
composed QP path of solver/qp.py, which runs the body with its Newton
solves through kernels 5-8 (``ops.qp_kernels``) and refinement sweeps.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib, qp_kernels

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
    """Largest alpha with v + alpha dv > 0, per scenario: (B, n) -> (B,);
    inf for n = 0, as solver/qp.py's ``_max_step``."""
    if v.shape[-1] == 0:
        return v.new_full(v.shape[:-1], float("inf"))
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return ratio.amin(-1)


def _compl(data, w, dz, sl, su, ll, lu, gl, gu, nl, nu):
    """Average complementarity (solver/qp.py ``_mu_of``), per scenario."""
    lh, uh, lb, ub = data[4], data[5], data[8], data[9]
    total = ((dz - lb) * nl).sum(-1) + ((ub - dz) * nu).sum(-1)
    total = total + (((w + sl - lh) * ll).sum(-1) + ((uh + su - w) * lu).sum(-1)
                     + (sl * gl).sum(-1) + (su * gu).sum(-1))
    return total / (2 * dz.shape[-1] + 4 * sl.shape[-1])


def ip_init(H, g, C, c0, lh, uh, z1, z2, lb, ub, mu0, box_margin, consts, warm=None):
    """(data, state) at the start of solver/qp.py's interior point.

    warm=None: the cold init.  Else ``warm`` holds the previous tick's
    (sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u): the slacks are
    re-feasibilized against the new rows, everything is floored strictly
    positive and mu is their complementarity (solver/qp.py:252-268)."""
    B = g.shape[0]
    lh_c = torch.clamp(lh, min=-BIG)
    uh_c = torch.clamp(uh, max=BIG)
    data = tuple(t.contiguous() for t in (H, C, g, c0, lh_c, uh_c, z1, z2, lb, ub))
    width = ub - lb
    dz = torch.clamp(torch.zeros_like(lb), lb + box_margin * (1 + width),
                     ub - box_margin * (1 + width))
    w0 = c0 + _mv(C, dz)
    if warm is None:
        sl = torch.clamp(lh_c - w0, min=0.0) + 0.1
        su = torch.clamp(w0 - uh_c, min=0.0) + 0.1
        duals = (sl, su, mu0 / (w0 + sl - lh_c), mu0 / (uh_c + su - w0), mu0 / sl, mu0 / su,
                 mu0 / (dz - lb), mu0 / (ub - dz))
        mu = torch.full((B,), mu0, dtype=g.dtype, device=g.device)
    else:
        sl = torch.clamp(torch.maximum(warm[0], lh_c - w0 + 1e-6), min=consts["p_floor"])
        su = torch.clamp(torch.maximum(warm[1], w0 - uh_c + 1e-6), min=consts["p_floor"])
        duals = (sl, su) + tuple(torch.clamp(d, min=consts["d_floor"]) for d in warm[2:])
        mu = torch.clamp(_compl(data, w0, dz, *duals), min=consts["mu_min"])
    state = (dz, *duals, mu, dz.clone(),
             torch.full((B,), float("inf"), dtype=g.dtype, device=g.device),
             torch.zeros_like(dz))
    return data, tuple(t.contiguous() for t in state)


def _newton(A, rhs, Cs, d_s, route="plain", fdt=None):
    """(x_aff, solve_more) for the Newton matrix M = A + Cs' diag(d_s) Cs:
    the predictor rhs (B, nz) solved and Woodbury-corrected, and a function
    that solves more right-hand sides (B, nz) the same way.

    ``route`` (solver/qp.py's ``chol_impl``, :425-488): 'plain', torch's
    Cholesky and solves, as chol_impl='xla' (kernel 4's plain version);
    'kernels', the wrappers of kernels 5-8, as chol_impl='pallas': kernels 7
    and 8 when k % 8 == 0, else kernels 5 and 6 with the Cs rows stacked
    under the rhs and the k x k T factored and solved in torch; 'custom',
    the blocked factorization of ``solver.linalg``, as chol_impl='custom'.
    ``fdt``: the dtype the factorizations and solves run in (the data's
    under a compute_dtype, :205-208); the rest stays in A's dtype."""
    dtype = A.dtype
    fdt = fdt or dtype
    f = lambda t: t.to(fdt).contiguous()
    back = lambda t: t.to(dtype)
    k = 0 if Cs is None else Cs.shape[1]
    if k:
        d_s_inv = torch.clamp(1.0 / torch.clamp(d_s, min=1e-30), max=1e30)
    if route == "kernels" and k and k % 8 == 0:
        Cs_f = f(Cs)
        X1, (L, Xs, Lt) = qp_kernels.stiff_factor_solve(f(A), f(rhs[:, None]), Cs_f,
                                                        f(d_s_inv))
        return back(X1[:, 0]), lambda r: back(qp_kernels.stiff_resolve(
            L, Xs, Lt, Cs_f, f(r[:, None]))[:, 0])
    RHS1 = torch.cat([rhs[:, None], Cs], 1) if k else rhs[:, None]
    if route == "custom":
        from ..solver import linalg

        fac, n = linalg.spd_factor_batched(f(A))

        def solve_rows(R):  # a single row by the vector sweep, as the JAX route
            if R.shape[1] == 1:
                return back(linalg.spd_factor_solve(fac, n, f(R[:, 0]))[:, None])
            return back(linalg.spd_factor_solve_mrhs(fac, n, f(R).transpose(-1, -2))
                        .transpose(-1, -2))

        X1 = solve_rows(RHS1)
        more = lambda r: solve_rows(r[:, None])[:, 0]
    else:
        if route == "kernels":
            factor_solve, solve = qp_kernels.factor_solve, qp_kernels.solve
        elif route == "plain":
            factor_solve, solve = qp_kernels.factor_solve_plain, qp_kernels.solve_plain
        else:
            raise ValueError(f"unknown Newton route {route!r}")
        X1, L = factor_solve(f(A), f(RHS1))
        X1 = back(X1)
        more = lambda r: back(solve(L, f(r[:, None]))[:, 0])
    if not k:
        return X1[:, 0], more
    Xs = X1[:, 1:]
    T = qp_kernels.woodbury_matrix(Cs, Xs, d_s_inv, eps=torch.finfo(fdt).eps)
    Lt = qp_kernels.chol_plain(f(T))

    def wood(x):
        return x - _mtv(Xs, back(torch.cholesky_solve(f(_mv(Cs, x)[..., None]), Lt)[..., 0]))

    return wood(X1[:, 0]), lambda r: wood(more(r))


def ip_iteration(data, state, k_s, it_idx, in_tail, c, route="plain", ir_steps=0, fdt=None):
    """One Mehrotra predictor-corrector iteration of solver/qp.py's body,
    batch-first; every scalar of the JAX body is a (B,) tensor here.  The
    Newton solves go through ``_newton`` (``route`` and ``fdt``, the
    factorization's dtype, as there); ``ir_steps`` refinement sweeps follow
    each solve (:490-503)."""
    H, C, g, c0, lh, uh, z1, z2, lb, ub = data
    dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu, best_dz, best_m, dzs = state
    dtype = dz.dtype
    eps = torch.finfo(dtype).eps

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
    Cs = d_s = None
    if k_s > 0:
        eta_raw = (ql_raw * (z2 + pl_raw) / (z2 + ql_raw + pl_raw)
                   + qu_raw * (z2 + pu_raw) / (z2 + qu_raw + pu_raw))
        # top-k_s with ties to the lowest index (lax.top_k ordering), kept
        # in top-k order
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

    if C.shape[1]:
        A = H + (C.transpose(-1, -2) * eta_mild[:, None, :]) @ C + torch.diag_embed(rb)
    else:  # nc = 0: solver/qp.py:375-378
        A = H + torch.diag_embed(rb)
    diagA = torch.diagonal(A, dim1=-2, dim2=-1)
    A = A + torch.diag_embed(10 * torch.finfo(fdt or dtype).eps * (diagA.abs() + 1.0))

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

    def m_apply(x):
        """Exact Newton-matrix product (mild rows capped, stiff exact)."""
        out = _mv(H, x) + rb * x
        if C.shape[1]:
            out = out + _mtv(C, eta_mild * _mv(C, x))
        if k_s > 0:
            out = out + _mtv(Cs, d_s * _mv(Cs, x))
        return out

    zc, zz = torch.zeros_like(sl), torch.zeros_like(dz)
    aff_t = (zc, zc, zc, zc, zz, zz)
    rhs_aff = rhs_of(*aff_t)

    # one factor + multi-solve for [rhs_aff; Cs]; the corrector reuses it
    x_aff, solve_more = _newton(A, rhs_aff, Cs, d_s, route, fdt)

    def finish(x, rhs):
        for _ in range(ir_steps):
            x = x + solve_more(rhs - m_apply(x))
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

    aff = recover(finish(x_aff, rhs_aff), *aff_t)
    alpha_aff = step_len(aff, 1.0)[:, None]
    adz, adw, adsl, adsu, adll, adlu, adgl, adgu, adnl, adnu = aff
    mu_cur = _compl(data, w, dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u)
    a = alpha_aff
    mu_aff = _compl(data, w + a * adw, dz + a * adz, sl + a * adsl, su + a * adsu,
                    lam_l + a * adll, lam_u + a * adlu, gam_l + a * adgl, gam_u + a * adgu,
                    nu_l + a * adnl, nu_u + a * adnu)
    sigma = torch.clamp((torch.clamp(mu_aff, min=0.0)
                         / torch.clamp(mu_cur, min=c["d_floor"])) ** 3, 1e-4, 1.0)
    mu_t = torch.clamp(sigma * mu_cur, min=c["mu_min"])[:, None]

    corr_t = (mu_t - adll * (adw + adsl), mu_t - adlu * (adsu - adw),
              mu_t - adgl * adsl, mu_t - adgu * adsu,
              mu_t - adnl * adz, mu_t + adnu * adz)
    rhs_c = rhs_of(*corr_t)
    corr = recover(finish(solve_more(rhs_c), rhs_c), *corr_t)
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
    mu = torch.clamp(_compl(data, w + alpha * dw, dz, sl, su, lam_l, lam_u, gam_l, gam_u,
                            nu_l, nu_u), min=c["mu_min"])
    if in_tail:
        dzs = dzs + dz
    return (dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu, best_dz, best_m, dzs)


def run_phase(data, state, k_s, n_iters, it0, consts, n_tail=0, **body):
    """n_iters iterations of the body from iteration it0, the last n_tail of
    them summed into the tail; ``body``: ``ip_iteration``'s route options."""
    for i in range(n_iters):
        state = ip_iteration(data, state, k_s, it0 + i, i >= n_iters - n_tail, consts, **body)
    return state


def ip_phase_plain(data, state, k_s, n_iters, it0, consts, n_tail=0):
    """n_iters iterations of solver/qp.py's body; k_s is clamped to nc."""
    return run_phase(data, state, min(k_s, data[3].shape[-1]), n_iters, it0, consts, n_tail)


def _ip_phase_cuda(data, state, k_s, n_iters, it0, consts, n_tail=0):
    with _lib.launch("ip_phase"):
        H, C = data[0], data[1]
        B, nz = H.shape[0], H.shape[-1]
        nc = C.shape[1]
        if k_s % 8 != 0 or k_s > nc:
            raise NotImplementedError(
                f"ip_phase kernel needs k_stiff % 8 == 0 and k_stiff <= nc, got k={k_s}, nc={nc} "
                "(`dual_warm_start`, an unaligned `qp_stiff_k` or `chol_impl: pallas` take the "
                "composed QP path)")
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
        return out


def ip_phase_geometry(nz, nc, k_s) -> dict:
    """Kernel 4's launch at (nz, nc, k_s) on the current card: threads per
    block, dynamic shared bytes per block, resident blocks per SM."""
    return _lib.geometry("ip_phase_geometry", nz, nc, k_s)


def ip_phase(data, state, k_s, n_iters, it0, consts, n_tail=0):
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if data[0].is_cuda:
        return _ip_phase_cuda(data, state, k_s, n_iters, it0, consts, n_tail)
    return ip_phase_plain(data, state, k_s, n_iters, it0, consts, n_tail)


def ip_schedule(iters, n_warm, k_stiff, nc):
    """([(k_s, n_iters, it0, n_tail), ...], n_tail): solver/qp.py's two-phase
    schedule (:594-604), which both QP paths run.  n_warm iterations without
    the stiff split, then the rest with k_s = min(k_stiff, nc) stiff rows;
    the tail average takes the last min(8, n_stiff) stiff iterates, once
    the stiff phase is long enough for an average."""
    n_stiff = iters - n_warm
    n_tail = min(8, n_stiff) if n_stiff >= 4 else 0
    phases = [(0, n_warm, 0, 0)] if n_warm > 0 else []
    if n_stiff > 0:
        phases.append((min(k_stiff, nc), n_stiff, n_warm, n_tail))
    return phases, n_tail


def ip_finish(data, state, n_tail):
    """(dz, kkt, mu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u): the
    final merit, the best-iterate choice, the tail average and the KKT
    residual (solver/qp.py:605-639)."""
    H, C, g, c0, lh_c, uh_c, z1, z2, lb, ub = data
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


def make_fused_solve(iters, n_warm, k_stiff, mu0, box_margin, ratio_cap_override=None):
    """run(H, g, C, c0, lh, uh, z1, z2, lb, ub) -> (dz, kkt, mu, sl, su, lam_l,
    lam_u, gam_l, gam_u, nu_l, nu_u) for one static configuration."""

    def run(H, g, C, c0, lh, uh, z1, z2, lb, ub):
        consts = ip_consts(g.dtype, ratio_cap_override)
        data, state = ip_init(H, g, C, c0, lh, uh, z1, z2, lb, ub, mu0, box_margin, consts)
        phases, n_tail = ip_schedule(iters, n_warm, k_stiff, c0.shape[-1])
        for k_s, n_iters, it0, tail in phases:
            state = ip_phase(data, state, k_s, n_iters, it0, consts, tail)
        return ip_finish(data, state, n_tail)

    return run
