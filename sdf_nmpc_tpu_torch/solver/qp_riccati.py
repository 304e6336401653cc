"""Stage-wise (Riccati) QP backend: the Mehrotra interior point whose Newton
systems are solved by a Riccati recursion over the horizon.

Counterpart of sdf_nmpc_tpu/solver/qp_riccati.py, batch-first: every field
of ``StageQpData`` carries the scenario axis first, and each ``lax.scan``
of the JAX module is a Python loop over the stages on (B, ...) tensors.
The JAX module has no Pallas kernel; neither has this one: the sweeps are
PyTorch ops (``torch.linalg.cholesky_ex`` / ``torch.cholesky_solve`` on the
(nu, nu) blocks).

Problem, per scenario (the condensed backend's problem class with the rows
kept stage-local, solver/qp.py):

    min   sum_k 1/2 dx_k'Q_k dx_k + du_k'Ssu_k dx_k + 1/2 du_k'R_k du_k
              + q_k'dx_k + r_k'du_k   (+ terminal k=N state terms)
              + sum_rows z1 (sl+su) + 1/2 z2 (sl^2+su^2)
    s.t.  dx_0 = e0,   dx_{k+1} = A_k dx_k + B_k du_k + b_k
          lh - sl <= c_k + Cx_k dx_k + Cu_k du_k <= uh + su
          (terminal rows on dx_N),   lb <= du <= ub

Each IP iteration runs one backward factor sweep (the per-stage Cholesky
of F, the gains K, kff), reuses it for the corrector (``_riccati_resolve``)
and, on the stiff iterations, for one resolve sweep per stiff row: the
k_stiff rows with the largest barrier coefficient leave the stage Hessians
and enter exactly through the k x k Woodbury system, as in the condensed
backend.  Iterates stay dynamics-feasible: the start rolls the clipped zero
step through the dynamics, and every direction satisfies ddx_0 = 0,
ddx_{k+1} = A ddx_k + B ddu_k.

The sweeps carry right-hand sides as columns: (B, N+1, nx, m) gradients,
where the JAX module vmaps one sweep per column (the k_s stiff rows share
one resolve sweep and one rollout).  Ties in
the stiff selection keep the lowest index, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ip_kernel import _max_step
from ..ops.qp_kernels import chol_plain

BIG = 1e8


class StageQpData(NamedTuple):
    """A batch of stage-structured QPs (B leading on every field)."""

    Q: torch.Tensor  # (B, N+1, nx, nx) state Hessians (incl. terminal; PSD + LM)
    q: torch.Tensor  # (B, N+1, nx)
    R: torch.Tensor  # (B, N, nu, nu)
    r: torch.Tensor  # (B, N, nu)
    Ssu: torch.Tensor  # (B, N, nu, nx) cross terms d2/du ddx
    A: torch.Tensor  # (B, N, nx, nx)
    B: torch.Tensor  # (B, N, nx, nu)
    b: torch.Tensor  # (B, N, nx) shooting defects
    e0: torch.Tensor  # (B, nx) initial-state defect x0 - X_0
    Cx: torch.Tensor  # (B, N, nh, nx) stage row state Jacobians (nh may be 0)
    Cu: torch.Tensor  # (B, N, nh, nu)
    c: torch.Tensor  # (B, N, nh) row values at (dx, du) = 0
    lh: torch.Tensor  # (B, nh)
    uh: torch.Tensor  # (B, nh)
    z1: torch.Tensor  # (B, N, nh) L1 slack weights (cost-scaled per stage)
    z2: torch.Tensor  # (B, N, nh)
    CxN: torch.Tensor  # (B, nhN, nx) terminal rows
    cN: torch.Tensor  # (B, nhN)
    lhN: torch.Tensor  # (B, nhN)
    uhN: torch.Tensor
    z1N: torch.Tensor
    z2N: torch.Tensor
    lb: torch.Tensor  # (B, N, nu) du box lower
    ub: torch.Tensor  # (B, N, nu)


class RiccatiQpResult(NamedTuple):
    ddx: torch.Tensor  # (B, N+1, nx)
    ddu: torch.Tensor  # (B, N, nu)
    kkt_residual: torch.Tensor  # (B,)
    complementarity: torch.Tensor  # (B,)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _mtv(M, x):
    return (M.transpose(-1, -2) @ x[..., None])[..., 0]


def _riccati_factor(Qb, qb, Rb, rb, Sb, A, Bm):
    """Backward sweep: the factorization and the affine gains in one pass.

    Qb (B, N+1, nx, nx), qb (B, N+1, nx), Rb (B, N, nu, nu), rb (B, N, nu),
    Sb (B, N, nu, nx) -> (K (B, N, nu, nx), kff (B, N, nu), Ls (B, N, nu,
    nu)): Ls per stage the Cholesky factor of F = R + B'PB (NaN where it
    fails, as jnp.linalg.cholesky), K = -F^-1 G, kff = -F^-1 h."""
    N = A.shape[1]
    P, p = Qb[:, N], qb[:, N]
    K, kff, Ls = [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        Ak, Bk = A[:, k], Bm[:, k]
        Bt = Bk.transpose(-1, -2)
        F = Rb[:, k] + Bt @ (P @ Bk)
        F = 0.5 * (F + F.transpose(-1, -2))
        G = Sb[:, k] + Bt @ (P @ Ak)  # (B, nu, nx)
        h = rb[:, k] + _mv(Bt, p)
        L = chol_plain(F)
        K[k] = -torch.cholesky_solve(G, L)
        kff[k] = -torch.cholesky_solve(h[..., None], L)[..., 0]
        Ls[k] = L
        Gt = G.transpose(-1, -2)
        P = Qb[:, k] + Ak.transpose(-1, -2) @ (P @ Ak) + Gt @ K[k]
        P = 0.5 * (P + P.transpose(-1, -2))
        p = qb[:, k] + _mtv(Ak, p) + _mv(Gt, kff[k])
    return torch.stack(K, 1), torch.stack(kff, 1), torch.stack(Ls, 1)


def _riccati_resolve(K, Ls, qb, rb, A, Bm):
    """Linear backward sweep for new gradients, reusing the factorization:
    qb (B, N+1, nx, m), rb (B, N, nu, m) -> kff (B, N, nu, m).  With
    K = -F^-1 G and F kff = -h, G'kff = K'h (JAX :126-140)."""
    N = A.shape[1]
    p = qb[:, N]
    kff = [None] * N
    for k in reversed(range(N)):
        h = rb[:, k] + Bm[:, k].transpose(-1, -2) @ p
        kff[k] = -torch.cholesky_solve(h, Ls[:, k])
        p = qb[:, k] + A[:, k].transpose(-1, -2) @ p + K[:, k].transpose(-1, -2) @ h
    return torch.stack(kff, 1)


def _rollout(K, kff, A, Bm):
    """Forward pass under homogeneous dynamics from ddx_0 = 0: kff (B, N, nu,
    m) -> (ddx (B, N+1, nx, m), ddu (B, N, nu, m))."""
    B_, N, nx = A.shape[:3]
    dx = kff.new_zeros(B_, nx, kff.shape[-1])
    dxs, dus = [], []
    for k in range(N):
        du = K[:, k] @ dx + kff[:, k]
        dxs.append(dx)
        dus.append(du)
        dx = A[:, k] @ dx + Bm[:, k] @ du
    dxs.append(dx)
    return torch.stack(dxs, 1), torch.stack(dus, 1)


def solve_qp_riccati(sq: StageQpData, iters: int = 20, mu0: float = 0.1,
                     box_margin: float = 1e-6, ratio_cap_override: float = None,
                     k_stiff: int = 8, stiff_iters: int = None) -> RiccatiQpResult:
    """Solve a batch of stage-structured QPs with ``iters`` Mehrotra
    iterations: the first iters - stiff_iters capped only, the last
    stiff_iters with the stiff rows split off (JAX :157-592)."""
    dtype = sq.q.dtype
    B_, N, nx = sq.A.shape[:3]
    nu = sq.B.shape[-1]
    nh = sq.Cx.shape[2]
    nhN = sq.CxN.shape[1]
    nz, nc = N * nu, N * nh + nhN
    Q, q, R, r, Ssu, A, Bm = sq.Q, sq.q, sq.R, sq.r, sq.Ssu, sq.A, sq.B
    Cx, Cu, CxN = sq.Cx, sq.Cu, sq.CxN

    lh_s = torch.clamp(sq.lh[:, None, :].expand(B_, N, nh), min=-BIG)
    uh_s = torch.clamp(sq.uh[:, None, :].expand(B_, N, nh), max=BIG)
    lh = torch.cat([lh_s.reshape(B_, N * nh), torch.clamp(sq.lhN, min=-BIG)], 1)
    uh = torch.cat([uh_s.reshape(B_, N * nh), torch.clamp(sq.uhN, max=BIG)], 1)
    z1 = torch.cat([sq.z1.reshape(B_, N * nh), sq.z1N], 1)
    z2 = torch.cat([sq.z2.reshape(B_, N * nh), sq.z2N], 1)
    lb, ub = sq.lb.reshape(B_, nz), sq.ub.reshape(B_, nz)

    eps = torch.finfo(dtype).eps
    mu_min = 32 * eps
    p_floor = mu_min * 1e-2
    d_floor = 1e-14
    tau = 0.995
    ratio_cap = 0.1 / eps if ratio_cap_override is None else float(ratio_cap_override)
    n_terms = 2 * nz + 4 * nc

    # ---- dynamics-feasible initial iterate ----
    width = ub - lb
    du0 = torch.minimum(torch.maximum(torch.zeros_like(lb), lb + box_margin * (1 + width)),
                        ub - box_margin * (1 + width)).reshape(B_, N, nu)
    dx = sq.e0
    dxs0 = []
    for k in range(N):
        dxs0.append(dx)
        dx = _mv(A[:, k], dx) + _mv(Bm[:, k], du0[:, k]) + sq.b[:, k]
    ddx = torch.stack(dxs0 + [dx], 1)  # (B, N+1, nx)
    ddu = du0

    def c_cols(dxs, dus):
        """C d for column-stacked directions dxs (B, N+1, nx, m), dus (B, N,
        nu, m): (B, nc, m), stage-major then the terminal rows."""
        w_s = Cx @ dxs[:, :N] + Cu @ dus
        return torch.cat([w_s.reshape(B_, N * nh, w_s.shape[-1]), CxN @ dxs[:, N]], 1)

    def c_apply(dxs, dus):
        return c_cols(dxs[..., None], dus[..., None])[..., 0]

    def row_vals(ddx, ddu):
        """All general-row values (B, nc), stage-major + terminal tail."""
        return torch.cat([sq.c.reshape(B_, N * nh), sq.cN], 1) + c_apply(ddx, ddu)

    def ct_apply(v):
        """C'v as stage gradients: (gx (B, N+1, nx), gu (B, N, nu))."""
        v_s = v[:, :N * nh].reshape(B_, N, nh)
        gx = torch.cat([_mtv(Cx, v_s), _mtv(CxN, v[:, N * nh:])[:, None]], 1)
        return gx, _mtv(Cu, v_s)

    def stage_grads(ddx, ddu):
        """(Q dx + q + S'du, R du + r + S dx) per stage (no row terms)."""
        gx = _mv(Q, ddx) + q
        gx = gx + torch.cat([_mtv(Ssu, ddu), gx.new_zeros(B_, 1, nx)], 1)
        gu = _mv(R, ddu) + r + _mv(Ssu, ddx[:, :N])
        return gx, gu

    def merit(ddx, ddu):
        """The exact penalized objective at a dynamics-feasible iterate, the
        du box by an exact-penalty distance."""
        f = (0.5 * (ddx * _mv(Q, ddx)).sum((1, 2)) + (q * ddx).sum((1, 2))
             + 0.5 * (ddu * _mv(R, ddu)).sum((1, 2)) + (r * ddu).sum((1, 2))
             + (ddu * _mv(Ssu, ddx[:, :N])).sum((1, 2)))
        w = row_vals(ddx, ddu)
        vl = torch.clamp(lh - w, min=0.0)
        vu = torch.clamp(w - uh, min=0.0)
        f = f + (z1 * (vl + vu) + 0.5 * z2 * (vl ** 2 + vu ** 2)).sum(-1)
        duf = ddu.reshape(B_, nz)
        return f + BIG * (duf - torch.minimum(torch.maximum(duf, lb), ub)).abs().sum(-1)

    def mu_of(ddx, ddu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u):
        duf = ddu.reshape(B_, nz)
        total = ((duf - lb) * nu_l).sum(-1) + ((ub - duf) * nu_u).sum(-1)
        if nc:
            w = row_vals(ddx, ddu)
            total = total + (((w + sl - lh) * lam_l).sum(-1) + ((uh + su - w) * lam_u).sum(-1)
                             + (sl * gam_l).sum(-1) + (su * gam_u).sum(-1))
        return total / n_terms

    # ---- IP state ----
    w0 = row_vals(ddx, ddu)
    duf = ddu.reshape(B_, nz)
    sl = torch.clamp(lh - w0, min=0.0) + 0.1
    su = torch.clamp(w0 - uh, min=0.0) + 0.1
    state = (ddx, ddu, sl, su, mu0 / (w0 + sl - lh), mu0 / (uh + su - w0), mu0 / sl, mu0 / su,
             mu0 / (duf - lb), mu0 / (ub - duf), torch.full((B_,), mu0, dtype=dtype,
                                                          device=lb.device))
    best = (ddx, ddu, torch.full((B_,), float("inf"), dtype=dtype, device=lb.device))

    # row i of the flattened rows as a stage-local gradient pair: its state
    # Jacobian sits at its stage (the terminal rows at N), its input Jacobian
    # at its stage (zero for the terminal rows)
    Cx_rows = torch.cat([Cx.reshape(B_, N * nh, nx), CxN], 1)  # (B, nc, nx)
    Cu_rows = torch.cat([Cu.reshape(B_, N * nh, nu), Cu.new_zeros(B_, nhN, nu)], 1)

    def body(k_s, state, best):
        ddx, ddu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu = state
        duf = ddu.reshape(B_, nz)
        w = row_vals(ddx, ddu)
        tl = torch.maximum(w + sl - lh, 4 * eps * (1.0 + w.abs() + sl))
        tu = torch.maximum(uh + su - w, 4 * eps * (1.0 + w.abs() + su))
        bl = torch.maximum(duf - lb, 4 * eps * (1.0 + duf.abs()))
        bu = torch.maximum(ub - duf, 4 * eps * (1.0 + duf.abs()))

        # stationarity residuals (stage form)
        gx_lam, gu_lam = ct_apply(lam_l - lam_u)
        r_x, r_u = stage_grads(ddx, ddu)
        r_x = r_x - gx_lam
        r_u = r_u - gu_lam - (nu_l - nu_u).reshape(B_, N, nu)
        r_sl = z1 + z2 * sl - lam_l - gam_l
        r_su = z1 + z2 * su - lam_u - gam_u

        # barrier coefficients: mild rows capped, the k_s largest-eta rows
        # split off for the exact Woodbury correction
        ql_raw, qu_raw = lam_l / tl, lam_u / tu
        pl_raw, pu_raw = gam_l / sl, gam_u / su

        def eta_of(ql_, qu_, pl_, pu_):
            return (ql_ * (z2 + pl_) / (z2 + ql_ + pl_)
                    + qu_ * (z2 + pu_) / (z2 + qu_ + pu_))

        if k_s > 0:
            # top-k_s with ties to the lowest index (lax.top_k ordering)
            sidx = torch.sort(eta_of(ql_raw, qu_raw, pl_raw, pu_raw), dim=-1, descending=True,
                              stable=True).indices[:, :k_s]
            stiff = torch.zeros_like(sl, dtype=torch.bool).scatter(1, sidx, True)
            cap = torch.where(stiff, torch.full_like(sl, float("inf")),
                              torch.full_like(sl, ratio_cap))
        else:
            cap = torch.full_like(sl, ratio_cap)
        ql, qu = torch.minimum(ql_raw, cap), torch.minimum(qu_raw, cap)
        pl, pu = torch.minimum(pl_raw, cap), torch.minimum(pu_raw, cap)
        d_l = z2 + ql + pl
        d_u = z2 + qu + pu
        eta = eta_of(ql, qu, pl, pu)
        rbl, rbu = nu_l / bl, nu_u / bu
        rb = (rbl + rbu).reshape(B_, N, nu)
        if k_s > 0:
            d_s = torch.gather(eta, 1, sidx)  # exact (uncapped) stiff coefficients
            eta = torch.where(stiff, torch.zeros_like(eta), eta)  # mild rows only

        # stage Hessians augmented by the (mild) barrier terms
        eta_s = eta[:, :N * nh].reshape(B_, N, nh)
        eta_N = eta[:, N * nh:]
        CxtE = Cx.transpose(-1, -2) * eta_s[..., None, :]  # (B, N, nx, nh)
        CutE = Cu.transpose(-1, -2) * eta_s[..., None, :]
        Qb = Q + torch.cat([CxtE @ Cx, (CxN.transpose(-1, -2) * eta_N[:, None, :] @ CxN)[:, None]],
                           1)
        Rb = R + CutE @ Cu + torch.diag_embed(rb)
        Sb = Ssu + CutE @ Cx
        # relative jitter keeps the f32 factorization sane
        Qb = Qb + torch.diag_embed(10 * eps * (torch.diagonal(Qb, dim1=-2, dim2=-1).abs() + 1.0))
        Rb = Rb + torch.diag_embed(10 * eps * (torch.diagonal(Rb, dim1=-2, dim2=-1).abs() + 1.0))

        def coeffs(m_tl, m_tu, m_sl, m_su):
            a_l = m_tl / tl - lam_l
            a_u = m_tu / tu - lam_u
            b_l = -r_sl + a_l + m_sl / sl - gam_l
            b_u = -r_su + a_u + m_su / su - gam_u
            return a_l, a_u, b_l, b_u

        def grad_of(m_tl, m_tu, m_sl, m_su, m_bl, m_bu):
            """The gradient (q_rhs, r_rhs) of the barrier-augmented model at
            the iterate: the direction minimizes 1/2 d'Hbar d + g'd."""
            a_l, a_u, b_l, b_u = coeffs(m_tl, m_tu, m_sl, m_su)
            gx_c, gu_c = ct_apply((a_l - ql * b_l / d_l) - (a_u - qu * b_u / d_u))
            r_rhs = r_u - gu_c - ((m_bl / bl - nu_l) - (m_bu / bu - nu_u)).reshape(B_, N, nu)
            return r_x - gx_c, r_rhs

        def recover(dxs, dus, m_tl, m_tu, m_sl, m_su, m_bl, m_bu):
            a_l, a_u, b_l, b_u = coeffs(m_tl, m_tu, m_sl, m_su)
            dw = c_apply(dxs, dus)
            dsl = (b_l - ql * dw) / d_l
            dsu = (b_u + qu * dw) / d_u
            ddz = dus.reshape(B_, nz)
            return (dxs, dus, dw, dsl, dsu, a_l - ql * (dw + dsl), a_u - qu * (dsu - dw),
                    (m_sl - gam_l * sl) / sl - pl * dsl, (m_su - gam_u * su) / su - pu * dsu,
                    (m_bl - nu_l * bl) / bl - rbl * ddz, (m_bu - nu_u * bu) / bu + rbu * ddz)

        # ---- predictor (affine) with the factor sweep ----
        zc, zz = torch.zeros_like(sl), torch.zeros_like(duf)
        aff_t = (zc, zc, zc, zc, zz, zz)
        q_rhs, r_rhs = grad_of(*aff_t)
        K, kff, Ls = _riccati_factor(Qb, q_rhs, Rb, r_rhs, Sb, A, Bm)

        if k_s > 0:
            # each stiff row as a stage gradient through one resolve sweep;
            # the rollouts of the sweeps' outputs are -y_i (the sweeps solve
            # Hbar d = -g); T = diag(1/d_s) + Cs Hbar^-1 Cs'
            rows_x = torch.gather(Cx_rows, 1, sidx[..., None].expand(-1, -1, nx))  # (B, k_s, nx)
            rows_u = torch.gather(Cu_rows, 1, sidx[..., None].expand(-1, -1, nu))
            stage = torch.where(sidx < N * nh, torch.div(sidx, max(nh, 1), rounding_mode="floor"),
                                torch.full_like(sidx, N))
            GX = Cx_rows.new_zeros(B_, k_s, N + 1, nx).scatter(
                2, stage[..., None, None].expand(-1, -1, 1, nx), rows_x[:, :, None])
            GU = Cu_rows.new_zeros(B_, k_s, N + 1, nu).scatter(
                2, stage[..., None, None].expand(-1, -1, 1, nu), rows_u[:, :, None])[:, :, :N]
            kff_rows = _riccati_resolve(K, Ls, GX.permute(0, 2, 3, 1), GU.permute(0, 2, 3, 1),
                                        A, Bm)  # (B, N, nu, k_s)
            y_dx, y_du = _rollout(K, kff_rows, A, Bm)  # = -y_i, column i
            CY = torch.gather(c_cols(y_dx, y_du), 1, sidx[..., None].expand(-1, -1, k_s))
            d_s_inv = torch.clamp(1.0 / torch.clamp(d_s, min=1e-30), max=1e30)
            T = -CY + torch.diag_embed(d_s_inv)
            T = T + torch.diag_embed(10 * eps * (torch.diagonal(T, dim1=-2, dim2=-1).abs()
                                                 + 1e-30))
            # jnp.linalg.cholesky reads the symmetrized matrix
            Lt = chol_plain(0.5 * (T + T.transpose(-1, -2)))

            def woodbury(dxs, dus):
                """d <- d - Y T^-1 Cs d (Y's columns are -(y_dx, y_du))."""
                cs_d = torch.gather(c_apply(dxs, dus), 1, sidx)
                t = torch.cholesky_solve(cs_d[..., None], Lt)  # (B, k_s, 1)
                return dxs + (y_dx @ t[:, None])[..., 0], dus + (y_du @ t[:, None])[..., 0]
        else:
            def woodbury(dxs, dus):
                return dxs, dus

        # the affine direction in a rollout of its own: sharing the stiff
        # rows' sweep changes its rounding, and near mu_min (f64) the
        # iterates then wander off where the JAX package's stay put
        roll_x, roll_u = _rollout(K, kff[..., None], A, Bm)
        aff = recover(*woodbury(roll_x[..., 0], roll_u[..., 0]), *aff_t)

        def step_len(d, frac):
            (_, dus, dw, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu) = d
            ddz = dus.reshape(B_, nz)
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

        a = step_len(aff, 1.0)
        (adx, adu, adw, adsl, adsu, adll, adlu, adgl, adgu, adnl, adnu) = aff
        adz = adu.reshape(B_, nz)
        a1, a3 = a[:, None], a[:, None, None]
        mu_cur = mu_of(ddx, ddu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u)
        mu_aff = mu_of(ddx + a3 * adx, ddu + a3 * adu, sl + a1 * adsl, su + a1 * adsu,
                       lam_l + a1 * adll, lam_u + a1 * adlu, gam_l + a1 * adgl,
                       gam_u + a1 * adgu, nu_l + a1 * adnl, nu_u + a1 * adnu)
        sigma = torch.clamp((torch.clamp(mu_aff, min=0.0) / torch.clamp(mu_cur, min=d_floor))
                            ** 3, 1e-4, 1.0)
        mu_t = torch.clamp(sigma * mu_cur, min=mu_min)[:, None]

        # ---- corrector reusing the factorization ----
        corr_t = (mu_t - adll * (adw + adsl), mu_t - adlu * (adsu - adw),
                  mu_t - adgl * adsl, mu_t - adgu * adsu, mu_t - adnl * adz, mu_t + adnu * adz)
        q_rhs2, r_rhs2 = grad_of(*corr_t)
        kff2 = _riccati_resolve(K, Ls, q_rhs2[..., None], r_rhs2[..., None], A, Bm)
        roll_x, roll_u = _rollout(K, kff2, A, Bm)
        corr = recover(*woodbury(roll_x[..., 0], roll_u[..., 0]), *corr_t)
        al = step_len(corr, tau)
        (dxs, dus, _, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu) = corr
        al1, al3 = al[:, None], al[:, None, None]

        ddx = ddx + al3 * dxs
        ddu = ddu + al3 * dus
        sl = torch.clamp(sl + al1 * dsl, min=p_floor)
        su = torch.clamp(su + al1 * dsu, min=p_floor)
        lam_l = torch.clamp(lam_l + al1 * dll, min=d_floor)
        lam_u = torch.clamp(lam_u + al1 * dlu, min=d_floor)
        gam_l = torch.clamp(gam_l + al1 * dgl, min=d_floor)
        gam_u = torch.clamp(gam_u + al1 * dgu, min=d_floor)
        nu_l = torch.clamp(nu_l + al1 * dnl, min=d_floor)
        nu_u = torch.clamp(nu_u + al1 * dnu, min=d_floor)
        mu = torch.clamp(mu_of(ddx, ddu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u),
                         min=mu_min)

        m_new = merit(ddx, ddu)
        better = m_new < best[2]
        best = (torch.where(better[:, None, None], ddx, best[0]),
                torch.where(better[:, None, None], ddu, best[1]), torch.minimum(m_new, best[2]))
        return (ddx, ddu, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u, mu), best

    # warm iterations capped only; the last stiff_iters carry the split
    n_stiff = 0
    if k_stiff > 0 and nc > 0:
        n_stiff = min(stiff_iters if stiff_iters is not None else iters, iters)
    for i in range(iters):
        state, best = body(min(k_stiff, nc) if i >= iters - n_stiff else 0, state, best)
    ddx, ddu = best[0], best[1]
    _, _, sl, su, lam_l, lam_u, _, _, _, _, mu = state

    # projected-gradient KKT report on the reduced gradient: the stage
    # gradients carried back through the dynamics by an adjoint sweep
    gx_lam, gu_lam = ct_apply(torch.minimum(lam_l, z1 + z2 * sl)
                              - torch.minimum(lam_u, z1 + z2 * su))
    grad_x, grad_u = stage_grads(ddx, ddu)
    grad_x, grad_u = grad_x - gx_lam, grad_u - gu_lam
    lam = grad_x[:, N]
    bt = [None] * N
    for k in reversed(range(N)):
        bt[k] = _mtv(Bm[:, k], lam)
        lam = _mtv(A[:, k], lam) + grad_x[:, k]
    grad_u = (grad_u + torch.stack(bt, 1)).reshape(B_, nz)
    duf = ddu.reshape(B_, nz)
    kkt = (duf - torch.minimum(torch.maximum(duf - grad_u, lb), ub)).abs().amax(-1)
    return RiccatiQpResult(ddx=ddx, ddu=ddu, kkt_residual=kkt, complementarity=mu)
