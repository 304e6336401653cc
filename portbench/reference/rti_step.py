"""Plain float64 reference of one SQP-RTI step of the neural-SDF NMPC
(BASELINE config 4: the ``att`` quadrotor, the trained NeuralDF, FoV rows,
the condensed QP under a fixed interior-point budget).

Written from the formulation, not from the program: plain ``torch`` (and
``torch.func`` for exact Jacobians) in float64, no kernel, no batching
trick.  One step, per scenario:

1. linearize: one RK4 step of the continuous dynamics and its exact
   Jacobians A, B; the stage residual y(x, u, p) - yref and its Jacobians;
   the stage rows h = [hfov, vfov, sdf] and the terminal rows (the same
   three) and their Jacobians; the terminal residual yN;
2. condense the equality constraints away: dx = e + E dz, dz the N nu
   control increments;
3. form the Gauss-Newton Hessian with Levenberg-Marquardt rows,
   H = M' diag(w) M + lm I, g = M' r;
4. run the Mehrotra predictor-corrector interior point on the soft-row QP
   (L1 + L2 slack penalties, box bounds on dz) for the budget's
   iterations: the first ``n_warm`` with every row's barrier ratio capped,
   the last ``n_stiff`` with the ``k_stiff`` stiffest rows exact and
   eliminated by a Woodbury correction; then the best iterate, the tail
   average and the final merit choose dz;
5. X += e + E dz, U += dz; a non-finite update keeps the old trajectory.

The ratio cap, the floors and the jitters are the interior point's own
numerics, taken at this reference's dtype (its machine epsilon).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

GRAVITY = 9.81
BIG = 1e8  # infinite row bounds are clamped to +-BIG
# the one formulation written here: the att model on a uniform grid, FoV and
# SDF constraint rows, no SDF cost, no terminal feasibility or stability rows
FORMULATION = dict(model="att", uniform_dt=True, enable_sdf=True, sdf_constraint=True,
                   vfov_constraint=True, sdf_cost=False, recursive_feasibility=False,
                   stability=False)


def _chol(A):
    """Lower Cholesky factor; NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[:, None, None], torch.full_like(L, math.nan), L)


# ---------------------------------------------------------------- geometry


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_rot(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)


def rot_rp(roll, pitch):
    """Rotation of roll then pitch, zero yaw (Z1Y2X3 Euler angles)."""
    cr, sr, cp, sp = torch.cos(roll), torch.sin(roll), torch.cos(pitch), torch.sin(pitch)
    z = torch.zeros_like(roll)
    return torch.stack([torch.stack([cp, sr * sp, cr * sp], -1),
                        torch.stack([z, cr, -sr], -1),
                        torch.stack([-sp, sr * cp, cr * cp], -1)], -2)


# ---------------------------------------------------------------- the network


class NeuralDfRef:
    """The SDF network from its flax parameter tree (numpy leaves): position
    embedding [x, sin(2^i a.x), cos(2^i a.x)] over the octahedron's eight
    directions a, two sine blocks, the embedding and latent concatenated
    again, two more sine blocks, a linear head."""

    def __init__(self, params: dict, sizes: dict, device, dtype=torch.float64):
        if sizes["embed"] != "oct" or sizes["act"] != "sin" or sizes["res"] != "full":
            raise ValueError(f"the reference network takes embed 'oct', act 'sin', res 'full', "
                             f"got {sizes}")
        p = params["params"] if "params" in params else params
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
        self.K = {k: t(p[k]["kernel"]) for k in ("main1_0", "main1_1", "main2_0", "main2_1", "df")}
        self.b = {k: t(p[k]["bias"]) for k in self.K}
        d = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                     np.float64).T
        self.dirs = t(d / np.linalg.norm(d, axis=0))  # (3, 8)
        self.freqs = t(2.0 ** np.arange(int(sizes["nb_freqs"])))
        self.w0 = float(sizes["w0"])

    def __call__(self, pos, latent):
        proj = pos @ self.dirs
        xb = (proj[..., None] * self.freqs).reshape(*proj.shape[:-1], -1)
        emb = torch.cat([pos, torch.sin(xb), torch.sin(xb + 0.5 * math.pi)], -1)
        lin = lambda h, k: h @ self.K[k] + self.b[k]
        act = lambda z: torch.sin(self.w0 * z)
        h = act(lin(torch.cat([emb, latent], -1), "main1_0"))
        h = act(lin(h, "main1_1"))
        h = act(lin(torch.cat([h, emb, latent], -1), "main2_0"))
        h = act(lin(h, "main2_1"))
        return lin(h, "df")[..., 0]


# ---------------------------------------------------------------- the OCP


class RtiReference:
    """One RTI step of the configuration ``conf`` (a portbench configuration
    file's dict) on ``device`` in ``dtype``.  Scenario tensors carry the
    batch first: X (S, N+1, nx), U (S, N, nu), p (S, N+1, np)."""

    def __init__(self, conf: dict, sdf_params: dict, device, dtype=torch.float64):
        self.c = conf
        self.dev, self.dtype = torch.device(device), dtype
        o = conf["ocp"]
        stated = dict(model=o["model"], uniform_dt=o["uniform_dt"], **conf["flags"])
        if stated != FORMULATION:
            raise ValueError(
                f"this reference implements only {FORMULATION}; the configuration states "
                f"{stated}: another formulation needs a reference file of its own under "
                "portbench/reference/ and a system under portbench/systems/ that uses it")
        self.N, self.nx, self.nu = int(o["N"]), int(o["nx"]), int(o["nu"])
        self.dt = float(o["T"]) / self.N
        lim = conf["robot"]["limits"]
        self.scale = self._t([lim["gamma"], lim["roll"], lim["pitch"], lim["wz"]])
        self.u_hover = self._t([GRAVITY / lim["gamma"], 0.0, 0.0, 0.0])
        self.lbu, self.ubu = self._t([0.0, -1.0, -1.0, -1.0]), self._t([1.0, 1.0, 1.0, 1.0])
        pi = conf["params"]
        self.i_flag, self.i_pc = pi["flag"], list(pi["W_p_Co"])
        self.i_rc, self.i_qd, self.i_lat = list(pi["W_R_Co"]), list(pi["q_d"]), pi["latent"]
        s = conf["sensor"]
        f32 = lambda v: float(np.float32(v))  # constants the configuration holds in float32
        self.cam_off = self._t([f32(v) for v in conf["robot"]["sensor_position"]])
        self.fov_off = self._t([f32(o["fov_const_offset"]), 0.0, 0.0])
        hl, vl = s["hfov"] * o["fov_ratio"], s["vfov"] * o["fov_ratio"]
        sdf_lo, sdf_hi = conf["robot"]["size_xy"] + o["bound_margin"], o["sdf_max_df"] + 0.2
        self.max_df = float(o["sdf_max_df"])
        fov_w, df_w = o["slack_fov"], o["slack_df"]
        rows = [(-hl, hl, *fov_w), (-vl, vl, *fov_w), (sdf_lo, sdf_hi, *df_w)]
        lo, up, z1, z2 = (np.array(c, np.float64) for c in zip(*rows))
        self.nh = self.nhN = len(rows)
        N = self.N
        # stage rows' penalties scale with the interval, terminal rows' do not
        self.lh = self._t(np.concatenate([np.tile(lo, N), lo]))
        self.uh = self._t(np.concatenate([np.tile(up, N), up]))
        self.z1 = self._t(np.concatenate([np.tile(z1 * self.dt, N), z1]))
        self.z2 = self._t(np.concatenate([np.tile(z2 * self.dt, N), z2]))
        self.lm = float(o["lm_reg"])
        self.net = NeuralDfRef(sdf_params, conf["sdf"], self.dev, dtype)
        self.qp = conf["qp"]

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.dev)

    # -- model --
    def _att(self, q, u):
        """(W_R_B, world acceleration) of a unit quaternion q and inputs u."""
        gamma, roll, pitch, _ = (u * self.scale).unbind(-1)
        yaw = torch.atan2(q[..., 3], q[..., 0])
        z = torch.zeros_like(yaw)
        q_yaw = torch.stack([torch.cos(yaw), z, z, torch.sin(yaw)], -1)
        W_R_B = quat_rot(q_yaw) @ rot_rp(roll, pitch)
        thrust = torch.stack([z, z, gamma], -1)
        acc = (W_R_B @ thrust[..., None])[..., 0] - self._t([0.0, 0.0, GRAVITY])
        return W_R_B, acc

    def f(self, x, u):
        q = x[..., 3:7] / torch.linalg.vector_norm(x[..., 3:7], dim=-1, keepdim=True)
        wz = (u * self.scale)[..., 3]
        z = torch.zeros_like(wz)
        dq = quat_mul(q, torch.stack([z, z, z, wz], -1)) / 2
        return torch.cat([x[..., 7:10], dq, self._att(q, u)[1]], -1)

    def rk4(self, x, u):
        h = self.dt
        k1 = self.f(x, u)
        k2 = self.f(x + 0.5 * h * k1, u)
        k3 = self.f(x + 0.5 * h * k2, u)
        k4 = self.f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def _q_err_z(self, x, p):
        q = x[..., 3:7] / torch.linalg.vector_norm(x[..., 3:7], dim=-1, keepdim=True)
        q_inv = q * self._t([1.0, -1.0, -1.0, -1.0])
        return quat_mul(p[..., self.i_qd], q_inv)[..., 3:4]

    def y(self, x, u, p):
        """Stage residual outputs: position, the yaw error's z component,
        velocity, roll, pitch, yaw rate, vertical world acceleration."""
        q = x[..., 3:7] / torch.linalg.vector_norm(x[..., 3:7], dim=-1, keepdim=True)
        _, roll, pitch, wz = (u * self.scale).unbind(-1)
        acc_z = self._att(q, u)[1][..., 2]
        return torch.cat([x[..., :3], self._q_err_z(x, p), x[..., 7:10],
                          torch.stack([roll, pitch, wz, acc_z], -1)], -1)

    def yN(self, x, p):
        return torch.cat([x[..., :3], self._q_err_z(x, p)], -1)

    # -- constraint rows --
    def rows(self, x, p):
        """[hfov, vfov, sdf] of one node: the body's position in the
        observation camera's frame feeds the network, the camera's (plus
        the FoV offset) the two angles; the flag gates all three."""
        R = p[..., self.i_rc].reshape(p.shape[:-1] + (3, 3))
        flag = p[..., self.i_flag]
        body = ((x[..., None, :3] - p[..., None, self.i_pc]) @ R)[..., 0, :]
        c = body + self.cam_off + self.fov_off
        hfov = flag * torch.atan2(c[..., 1], c[..., 0])
        vfov = flag * torch.atan2(c[..., 2], torch.linalg.vector_norm(c[..., :2], dim=-1))
        sdf = flag * self.net(body, p[..., self.i_lat:]) + (1 - flag) * self.max_df
        return torch.stack([hfov, vfov, sdf], -1)

    # -- the step --
    def init_state(self, x0):
        S = x0.shape[0]
        x0 = x0.to(self.dev, self.dtype)
        return (x0[:, None].expand(S, self.N + 1, self.nx).clone(),
                self.u_hover.expand(S, self.N, self.nu).clone())

    def step(self, X, U, inp: dict, budget: str):
        """(X_new, U_new, ok) of one RTI step from (X, U) on the inputs
        ``inp`` (x0, yref, W, yrefN, WN, p)."""
        N, nx, nu = self.N, self.nx, self.nu
        cast = lambda t: t.to(self.dev, self.dtype)
        X, U = cast(X), cast(U)
        x0, yref, W, yrefN, WN, p = (cast(inp[k]) for k in ("x0", "yref", "W", "yrefN", "WN", "p"))
        S = X.shape[0]
        Xk, Uk, Pk = X[:, :N].reshape(-1, nx), U.reshape(-1, nu), p[:, :N].reshape(-1, p.shape[-1])

        x_next = vmap(self.rk4)(Xk, Uk)
        A, Bm = vmap(jacfwd(self.rk4, argnums=(0, 1)))(Xk, Uk)
        y_val = vmap(self.y)(Xk, Uk, Pk)
        Jyx, Jyu = vmap(jacfwd(self.y, argnums=(0, 1)))(Xk, Uk, Pk)
        h = vmap(self.rows)(Xk, Pk)
        Jhx = vmap(jacfwd(self.rows, argnums=0))(Xk, Pk)
        ny, nh = y_val.shape[-1], self.nh
        A, Bm = A.reshape(S, N, nx, nx), Bm.reshape(S, N, nx, nu)
        res = (y_val.reshape(S, N, ny) - yref)
        Jyx, Jyu = Jyx.reshape(S, N, ny, nx), Jyu.reshape(S, N, ny, nu)
        h, Jhx = h.reshape(S, N, nh), Jhx.reshape(S, N, nh, nx)
        defect = x_next.reshape(S, N, nx) - X[:, 1:]
        xN, pN = X[:, N], p[:, N]
        resN = vmap(self.yN)(xN, pN) - yrefN
        JxN = vmap(jacfwd(self.yN, argnums=0))(xN, pN)
        hN, JhN = vmap(self.rows)(xN, pN), vmap(jacfwd(self.rows, argnums=0))(xN, pN)

        # condensing: dx_k = e_k + E_k dz, dx_0 = x0 - X_0
        nz = N * nu
        E = X.new_zeros(S, nx, nz)
        e = x0 - X[:, 0]
        es, Es = [], []
        for k in range(N):
            es.append(e)
            Es.append(E)
            e = (A[:, k] @ e[..., None])[..., 0] + defect[:, k]
            E = A[:, k] @ E
            E[:, :, k * nu:(k + 1) * nu] += Bm[:, k]
        e_st, E_st = torch.stack(es, 1), torch.stack(Es, 1)  # (S, N, nx), (S, N, nx, nz)
        G = Jyx @ E_st
        C = Jhx @ E_st
        for k in range(N):
            G[:, k, :, k * nu:(k + 1) * nu] += Jyu[:, k]
        res_c = res + (Jyx @ e_st[..., None])[..., 0]
        c_st = h + (Jhx @ e_st[..., None])[..., 0]

        # Gauss-Newton Hessian with the Levenberg-Marquardt rows
        Ws = W * self.dt
        E_all, e_all = torch.cat([E_st, E[:, None]], 1), torch.cat([e_st, e[:, None]], 1)
        M = torch.cat([G.reshape(S, N * ny, nz), JxN @ E,
                       E_all.reshape(S, (N + 1) * nx, nz)], 1)
        w = torch.cat([Ws.reshape(S, -1), WN, torch.full((S, (N + 1) * nx), self.lm,
                                                          dtype=self.dtype, device=self.dev)], 1)
        r = torch.cat([(Ws * res_c).reshape(S, -1), WN * (resN + (JxN @ e[..., None])[..., 0]),
                       self.lm * e_all.reshape(S, -1)], 1)
        H = M.mT @ (w[..., None] * M) + self.lm * torch.eye(nz, dtype=self.dtype, device=self.dev)
        g = (M.mT @ r[..., None])[..., 0]
        Cq = torch.cat([C.reshape(S, N * nh, nz), JhN @ E], 1)
        c0 = torch.cat([c_st.reshape(S, -1), hN + (JhN @ e[..., None])[..., 0]], 1)
        lb, ub = (self.lbu - U).reshape(S, nz), (self.ubu - U).reshape(S, nz)

        dz = self.solve_qp(H, g, Cq, c0, lb, ub, budget)
        X_new = X + e_all + (E_all @ dz[:, None, :, None])[..., 0]
        U_new = U + dz.reshape(S, N, nu)
        ok = torch.isfinite(X_new).flatten(1).all(1) & torch.isfinite(U_new).flatten(1).all(1)
        X_new = torch.where(ok[:, None, None], X_new, X)
        U_new = torch.where(ok[:, None, None], U_new, U)
        return X_new, U_new, ok

    # -- the QP --
    def schedule(self, budget: str):
        """(iterations, stiff iterations) of a budget."""
        b = self.qp["budgets"][budget]
        return int(b["iters"]), int(b["stiff_iters"])

    def solve_qp(self, H, g, C, c0, lb, ub, budget):
        eps = torch.finfo(self.dtype).eps
        mu_min, p_floor, d_floor, tau = 32 * eps, 32 * eps * 1e-2, 1e-14, 0.995
        ratio_cap = 0.1 / eps
        iters, n_stiff = self.schedule(budget)
        k_stiff = min(int(self.qp["k_stiff"]), C.shape[1])
        n_warm = iters - n_stiff
        n_tail = min(8, n_stiff) if n_stiff >= 4 else 0
        mu0, margin = float(self.qp["barrier_init"]), float(self.qp["box_margin"])
        S = g.shape[0]
        lh = torch.clamp(self.lh, min=-BIG).expand(S, -1)
        uh = torch.clamp(self.uh, max=BIG).expand(S, -1)
        z1, z2 = self.z1.expand(S, -1), self.z2.expand(S, -1)
        mv = lambda Mx, v: (Mx @ v[..., None])[..., 0]
        mtv = lambda Mx, v: (Mx.mT @ v[..., None])[..., 0]

        width = ub - lb
        dz = torch.clamp(torch.zeros_like(lb), lb + margin * (1 + width), ub - margin * (1 + width))
        w0 = c0 + mv(C, dz)
        sl = torch.clamp(lh - w0, min=0.0) + 0.1
        su = torch.clamp(w0 - uh, min=0.0) + 0.1
        lam_l, lam_u = mu0 / (w0 + sl - lh), mu0 / (uh + su - w0)
        gam_l, gam_u = mu0 / sl, mu0 / su
        nu_l, nu_u = mu0 / (dz - lb), mu0 / (ub - dz)
        best_dz, best_m = dz.clone(), torch.full((S,), math.inf, dtype=self.dtype, device=self.dev)
        tail_sum = torch.zeros_like(dz)

        def merit(z):
            wz = c0 + mv(C, z)
            vl, vu = torch.clamp(lh - wz, min=0.0), torch.clamp(wz - uh, min=0.0)
            return (0.5 * (z * mv(H, z)).sum(-1) + (g * z).sum(-1)
                    + (z1 * (vl + vu) + 0.5 * z2 * (vl ** 2 + vu ** 2)).sum(-1))

        def compl(w, dz, sl, su, ll, lu, gl, gu, nl, nu):
            tot = (((dz - lb) * nl).sum(-1) + ((ub - dz) * nu).sum(-1)
                   + ((w + sl - lh) * ll).sum(-1) + ((uh + su - w) * lu).sum(-1)
                   + (sl * gl).sum(-1) + (su * gu).sum(-1))
            return tot / (2 * dz.shape[-1] + 4 * sl.shape[-1])

        def max_step(v, dv):
            neg = dv < 0
            r = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(v, math.inf))
            return r.amin(-1)

        for it in range(iters):
            k_s = k_stiff if it >= n_warm else 0
            w = c0 + mv(C, dz)
            tl = torch.maximum(w + sl - lh, 4 * eps * (1.0 + w.abs() + sl))
            tu = torch.maximum(uh + su - w, 4 * eps * (1.0 + w.abs() + su))
            bl = torch.maximum(dz - lb, 4 * eps * (1.0 + dz.abs()))
            bu = torch.maximum(ub - dz, 4 * eps * (1.0 + dz.abs()))
            Hdz = mv(H, dz)
            r_z = Hdz + g - mtv(C, lam_l - lam_u) - nu_l + nu_u
            r_sl = z1 + z2 * sl - lam_l - gam_l
            r_su = z1 + z2 * su - lam_u - gam_u
            m_cur = merit(dz)
            better = (m_cur < best_m) & (it > 0)
            best_dz = torch.where(better[:, None], dz, best_dz)
            best_m = torch.where(better, m_cur, best_m)

            ql_raw, qu_raw, pl_raw, pu_raw = lam_l / tl, lam_u / tu, gam_l / sl, gam_u / su
            cap = torch.full_like(sl, ratio_cap)
            if k_s:
                eta_raw = (ql_raw * (z2 + pl_raw) / (z2 + ql_raw + pl_raw)
                           + qu_raw * (z2 + pu_raw) / (z2 + qu_raw + pu_raw))
                sidx = torch.sort(eta_raw, dim=-1, descending=True, stable=True).indices[:, :k_s]
                stiff = torch.zeros_like(sl, dtype=torch.bool).scatter(1, sidx, True)
                cap = torch.where(stiff, torch.full_like(sl, math.inf), cap)
            ql, qu = torch.minimum(ql_raw, cap), torch.minimum(qu_raw, cap)
            pl, pu = torch.minimum(pl_raw, cap), torch.minimum(pu_raw, cap)
            d_l, d_u = z2 + ql + pl, z2 + qu + pu
            eta = ql * (z2 + pl) / d_l + qu * (z2 + pu) / d_u
            rbl, rbu = nu_l / bl, nu_u / bu
            eta_mild = torch.where(stiff, torch.zeros_like(eta), eta) if k_s else eta
            Amat = H + (C.mT * eta_mild[:, None, :]) @ C + torch.diag_embed(rbl + rbu)
            Amat = Amat + torch.diag_embed(
                10 * eps * (torch.diagonal(Amat, dim1=-2, dim2=-1).abs() + 1.0))
            L = _chol(Amat)
            if k_s:
                Cs = torch.gather(C, 1, sidx[..., None].expand(-1, -1, C.shape[-1]))
                ds_inv = torch.clamp(1.0 / torch.clamp(torch.gather(eta, 1, sidx), min=1e-30),
                                     max=1e30)
                Xs = torch.cholesky_solve(Cs.mT, L).mT  # rows A^-1 Cs'
                T = Cs @ Xs.mT + torch.diag_embed(ds_inv)
                T = T + torch.diag_embed(10 * eps * (torch.diagonal(T, dim1=-2, dim2=-1).abs()
                                                     + 1e-30))
                Lt = _chol(T)

            def newton(rhs):
                x = torch.cholesky_solve(rhs[..., None], L)[..., 0]
                if k_s:
                    x = x - mtv(Xs, torch.cholesky_solve(mv(Cs, x)[..., None], Lt)[..., 0])
                return torch.where(torch.isfinite(x).all(-1, keepdim=True), x, torch.zeros_like(x))

            def coeffs(m_tl, m_tu, m_sl, m_su):
                a_l, a_u = m_tl / tl - lam_l, m_tu / tu - lam_u
                return a_l, a_u, -r_sl + a_l + m_sl / sl - gam_l, -r_su + a_u + m_su / su - gam_u

            def rhs_of(m_tl, m_tu, m_sl, m_su, m_bl, m_bu):
                a_l, a_u, b_l, b_u = coeffs(m_tl, m_tu, m_sl, m_su)
                return (-r_z + mtv(C, (a_l - ql * b_l / d_l) - (a_u - qu * b_u / d_u))
                        + (m_bl / bl - nu_l) - (m_bu / bu - nu_u))

            def recover(ddz, m_tl, m_tu, m_sl, m_su, m_bl, m_bu):
                a_l, a_u, b_l, b_u = coeffs(m_tl, m_tu, m_sl, m_su)
                dw = mv(C, ddz)
                dsl, dsu = (b_l - ql * dw) / d_l, (b_u + qu * dw) / d_u
                return (ddz, dw, dsl, dsu, a_l - ql * (dw + dsl), a_u - qu * (dsu - dw),
                        (m_sl - gam_l * sl) / sl - pl * dsl, (m_su - gam_u * su) / su - pu * dsu,
                        (m_bl - nu_l * bl) / bl - rbl * ddz, (m_bu - nu_u * bu) / bu + rbu * ddz)

            def step_len(d, frac):
                ddz, dw, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu = d
                m = torch.stack([max_step(sl, dsl), max_step(su, dsu), max_step(tl, dw + dsl),
                                 max_step(tu, dsu - dw), max_step(lam_l, dll),
                                 max_step(lam_u, dlu), max_step(gam_l, dgl), max_step(gam_u, dgu),
                                 max_step(nu_l, dnl), max_step(nu_u, dnu), max_step(bl, ddz),
                                 max_step(bu, -ddz)], 0).amin(0)
                return torch.clamp(frac * m, max=1.0)[:, None]

            zc, zz = torch.zeros_like(sl), torch.zeros_like(dz)
            aff_m = (zc, zc, zc, zc, zz, zz)
            aff = recover(newton(rhs_of(*aff_m)), *aff_m)
            a = step_len(aff, 1.0)
            adz, adw, adsl, adsu, adll, adlu, adgl, adgu, adnl, adnu = aff
            mu_cur = compl(w, dz, sl, su, lam_l, lam_u, gam_l, gam_u, nu_l, nu_u)
            mu_aff = compl(w + a * adw, dz + a * adz, sl + a * adsl, su + a * adsu,
                           lam_l + a * adll, lam_u + a * adlu, gam_l + a * adgl,
                           gam_u + a * adgu, nu_l + a * adnl, nu_u + a * adnu)
            sigma = torch.clamp((torch.clamp(mu_aff, min=0.0) / torch.clamp(mu_cur, min=d_floor))
                                ** 3, 1e-4, 1.0)
            mu_t = torch.clamp(sigma * mu_cur, min=mu_min)[:, None]
            corr_m = (mu_t - adll * (adw + adsl), mu_t - adlu * (adsu - adw),
                      mu_t - adgl * adsl, mu_t - adgu * adsu, mu_t - adnl * adz,
                      mu_t + adnu * adz)
            corr = recover(newton(rhs_of(*corr_m)), *corr_m)
            al = step_len(corr, tau)
            ddz, dw, dsl, dsu, dll, dlu, dgl, dgu, dnl, dnu = corr
            dz = dz + al * ddz
            sl = torch.clamp(sl + al * dsl, min=p_floor)
            su = torch.clamp(su + al * dsu, min=p_floor)
            lam_l = torch.clamp(lam_l + al * dll, min=d_floor)
            lam_u = torch.clamp(lam_u + al * dlu, min=d_floor)
            gam_l = torch.clamp(gam_l + al * dgl, min=d_floor)
            gam_u = torch.clamp(gam_u + al * dgu, min=d_floor)
            nu_l = torch.clamp(nu_l + al * dnl, min=d_floor)
            nu_u = torch.clamp(nu_u + al * dnu, min=d_floor)
            if it >= iters - n_tail:
                tail_sum = tail_sum + dz

        m_fin = merit(dz)
        dz = torch.where((m_fin < best_m)[:, None], dz, best_dz)
        if n_tail:
            avg = tail_sum / n_tail
            dz = torch.where((merit(avg) < torch.minimum(best_m, m_fin))[:, None], avg, dz)
        return dz
