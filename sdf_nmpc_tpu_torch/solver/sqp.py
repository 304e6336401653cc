"""SQP-RTI step, batch-first: linearize -> condense -> QP -> update.

Counterpart of sdf_nmpc_tpu/solver/sqp.py ``make_rti_step`` on both QP
backends.  The JAX step is single-scenario and reaches its kernels through
``custom_vmap`` rules; here every tensor carries the scenario axis first,
(B, N+1, nx) and the like, and the step calls the kernel wrappers
directly:

  1. ``ops.lin_kernels.lin_y_sens``   RK4 + A, B + stage residual + Jyx, Jyu
     (models with ``y_lanes``, att, acc, att_tau, when the OCP's residual is
     the model's), or
  9. ``ops.lin_kernels.erk4_sens``    RK4 + A, B (rates, wrench, props; every
     model under ``flags.sdf_cost``), the stage residual and its Jacobians
     then by ``torch.func``
  2. ``ops.sdf_fused.sdf_value_grad`` NeuralDF value + position gradient
     (``solver.sdf_fused_dtype``: f32, the default 3xTF32 route, bf16 or
     mixed); for a NeuralDF with res != 'full', an SDF callable
     (``ocp.SdfFn``) or under ``solver.fused_sdf: False`` the autodiff row
     (``ocp.autodiff_value_grad``, torch.func), as the JAX step takes it
     without a fused value+grad.  Only on the SDF row's fast path
     (``ocp.sdf_row_batch``: sdf_constraint on, sdf_cost off); otherwise
     every stage row goes through ``torch.func``, jacrev for fewer than
     (nx + nu) / 2 rows, else jacfwd, as the JAX step
  3. ``ops.condense_kernel.condense`` condensing recursion + condensed rows
     (at nh = 0, BASELINE config 1, its plain version, as the JAX step)
  4. ``ops.ip_kernel.ip_phase``       (inside ``solve_qp``) two IP phases, or
  5-8. ``ops.qp_kernels``             (inside ``solve_qp``) the composed QP
     path's Newton solves, one factor and one or more solves per iteration

``solve_qp`` picks the fused kernel 4 or the composed path from the config
(``chol_impl``, ``dual_warm_start``, ``ir_steps``, ``qp_stiff_k``,
``qp_compute_dtype``) and the rows (nc = 0 takes the composed path), as the
JAX step does; ``chol_impl`` 'xla' and 'custom' run the composed path on
torch.linalg or on solver/linalg.py.  With ``dual_warm_start`` the state
carries the QP duals from tick to tick (acados' ``qp_solver_warm_start``).

``qp_backend`` 'riccati' (and 'auto' beyond N = 20, ``resolve_qp_backend``)
skips steps 3-5: the stage Hessians go to ``solver.qp_riccati``'s
stage-wise interior point, which runs PyTorch ops (the JAX package has no
Pallas kernel there), after kernels 1 or 9 and 2.  ``lin_impl`` 'xla'
linearizes by torch.func and condenses by the plain recursion (no kernel
1, 9 or 3); ``qp_data_bf16`` rounds H and C to bf16 before the QP.

Each call of the step is the profiler span ``nmpc.step`` (``utils.timing.span``),
its stages the child spans ``nmpc.step.lin``, ``.rows``, ``.terminal``,
``.condense``, ``.gram``, ``.qp`` and ``.update``, in that order, on both QP
backends (the Riccati backend condenses nothing: its ``condense`` span holds
the initial-state defect alone).

The FoV-row, extension-row, ``yN`` and terminal ``hN`` Jacobians use
``torch.func``; the Gram H/g assembly (``gram``) accumulates in f64, where
the JAX step forms it in f32.  A non-finite update leaves the scenario's
warm start untouched and reports STATUS_NAN.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from ..ocp import OcpSpec, autodiff_value_grad
from ..ops import condense_kernel, lin_kernels, sdf_fused
from ..utils.timing import span
from .qp import CHOL_IMPLS, QpData, QpDuals, solve_qp
from .qp_riccati import StageQpData, solve_qp_riccati

STATUS_OK = 0
STATUS_NAN = 1
STATUS_NOT_CONVERGED = 2  # KKT residual above cfg.solver.kkt_tol (state kept)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# rows of an f32 M per f64 chunk of the Gram product: at B=8192, nz=80 a
# chunk and its weighted transpose take 1.34 GB, about what the one f32
# weighted copy of M took (att: 1.15 GB, props: 1.59 GB)
GRAM_CHUNK = 128


def gram(M_rows, w_rows, r_rows, lm: float, dtype):
    """H = M' diag(w) M + lm I and g = M' r of the condensed QP, for M_rows
    (B, R, nz), w_rows and r_rows (B, R).

    The products accumulate in f64 and are rounded once to ``dtype``; the
    JAX step forms them in f32.  An f32 M is cast GRAM_CHUNK rows at a
    time, so that its f64 copies stay small; an f64 M goes in one product.
    Measured on props' cold scenarios: with f32 Gram products the port's
    f32 step lay beyond the CI gate on the H100 (PERF.md section 6,
    ``utils/f32_floor.py``)."""
    B, R, nz = M_rows.shape
    H = M_rows.new_zeros(B, nz, nz, dtype=torch.float64)
    g = M_rows.new_zeros(B, nz, 1, dtype=torch.float64)
    w, r = w_rows.double(), r_rows.double()
    chunk = R if M_rows.dtype == torch.float64 else GRAM_CHUNK
    for i in range(0, R, chunk):
        rows = slice(i, i + chunk)
        Mt = M_rows[:, rows].double().mT
        H.baddbmm_(Mt * w[:, None, rows], Mt.mT)
        g.baddbmm_(Mt, r[:, rows, None])
    # + lm I after the products: an f64 step's dual-warm-started tick can
    # turn on the last bit of H (ROADMAP.md section 3)
    H.diagonal(dim1=1, dim2=2).add_(lm)
    return H.to(dtype), g[..., 0].to(dtype)


def resolve_stiff_knobs(cfg):
    """(k_stiff, stiff_iters, ratio_cap) with flags-adaptive 'auto' defaults."""
    rf = bool(cfg.flags.recursive_feasibility)
    k = cfg.solver.get("qp_stiff_k", "auto")
    if k in (None, "auto"):
        k = 48 if rf else 8
    si = cfg.solver.get("qp_stiff_iters", "auto")
    if si == "auto":
        si = 16 if rf else 8
    cap = cfg.solver.get("qp_ratio_cap", "auto")
    if cap == "auto":
        cap = 1e8
    return int(k), (None if si is None else int(si)), (None if cap is None else float(cap))


def resolve_iter_budget(cfg, budget: str) -> int:
    """Total IP iterations for a budget phase (cold 20, warm 18, steady 15 on
    the standard OCP)."""
    rf = bool(cfg.flags.recursive_feasibility)
    cold = cfg.solver.get("qp_iters", "auto")
    if cold in (None, "auto"):
        cold = 26 if rf else 20
    if budget == "cold":
        return int(cold)
    warm = cfg.solver.get("qp_iters_warm", "auto")
    if warm in (None, "auto"):
        warm = 22 if rf else 18
    if budget == "warm":
        return int(warm)
    steady = cfg.solver.get("qp_iters_steady", "auto")
    if steady in (None, "auto"):
        steady = warm if rf else 15
    return int(steady)


def resolve_qp_backend(cfg, N: int) -> str:
    """'auto' is condensed up to N=20 and riccati beyond."""
    qp_backend = str(cfg.solver.get("qp_backend", "auto"))
    if qp_backend == "auto":
        qp_backend = "condensed" if N <= 20 else "riccati"
    return qp_backend


class SolverState(NamedTuple):
    X: torch.Tensor  # (B, N+1, nx)
    U: torch.Tensor  # (B, N, nu)
    qp_duals: Optional[QpDuals] = None


class SolveInputs(NamedTuple):
    x0: torch.Tensor  # (B, nx)
    yref: torch.Tensor  # (B, N, ny)
    W: torch.Tensor  # (B, N, ny) diagonal weights
    yrefN: torch.Tensor  # (B, nyN)
    WN: torch.Tensor  # (B, nyN)
    p: torch.Tensor  # (B, N+1, np)


class SolveResult(NamedTuple):
    state: SolverState
    u0: torch.Tensor  # (B, nu)
    status: torch.Tensor  # (B,) int32: 0 ok, 1 NaN-rejected, 2 not converged
    kkt_residual: torch.Tensor  # (B,)
    qp_complementarity: torch.Tensor  # (B,)
    evals: Optional[torch.Tensor]  # (B, N+1, neval) diagnostics or None


def init_state(ocp: OcpSpec, x0, dtype=torch.float32,
               dual_warm_start: bool = False) -> SolverState:
    """Fill all nodes with x0 (B, nx) / u_hover, on the OCP's device.  With
    dual_warm_start, also seed the QP duals the first tick starts from
    (slacks 0.1, every dual 1)."""
    x0 = torch.as_tensor(x0, dtype=dtype, device=ocp.device)
    B = x0.shape[0]
    u_h = torch.as_tensor(ocp.u_hover, dtype=dtype, device=ocp.device)
    duals = None
    if dual_warm_start:
        nc, nz = ocp.N * ocp.nh + ocp.nhN, ocp.N * ocp.nu
        c1 = torch.full((B, nc), 0.1, dtype=dtype, device=ocp.device)
        d1 = torch.ones((B, nc), dtype=dtype, device=ocp.device)
        z1 = torch.ones((B, nz), dtype=dtype, device=ocp.device)
        duals = QpDuals(sl=c1, su=c1, lam_l=d1, lam_u=d1, gam_l=d1, gam_u=d1, nu_l=z1, nu_u=z1)
    return SolverState(X=x0[:, None, :].expand(B, ocp.N + 1, ocp.nx).clone(),
                       U=u_h.expand(B, ocp.N, ocp.nu).clone(), qp_duals=duals)


def shift_state(state: SolverState, k: int) -> SolverState:
    """Shift-by-k warm start; the vacated tail nodes keep their values."""
    if k <= 0:
        return state
    X, U = state.X.clone(), state.U.clone()
    if k < X.shape[1]:
        X[:, :-k] = state.X[:, k:]
    if k < U.shape[1]:
        U[:, :-k] = state.U[:, k:]
    return SolverState(X=X, U=U, qp_duals=state.qp_duals)


def _budget_knobs(cfg, budget: str):
    """(qp_iters, k_stiff, stiff_iters, ratio_cap) for a budget phase."""
    if budget not in ("cold", "warm", "steady"):
        raise ValueError(f"unknown budget {budget!r}")
    qp_iters = resolve_iter_budget(cfg, budget)
    k_stiff, stiff_iters, ratio_cap = resolve_stiff_knobs(cfg)
    if budget in ("warm", "steady"):
        stiff_iters = cfg.solver.get("qp_stiff_iters_warm", stiff_iters)
    if budget == "steady":
        ss = cfg.solver.get("qp_stiff_iters_steady", "auto")
        if ss == "auto":
            if (bool(cfg.flags.recursive_feasibility) or stiff_iters is None
                    or int(stiff_iters) == 0):
                ss = stiff_iters
            else:
                ss = 4
        stiff_iters = None if ss is None else int(ss)
    # the ratio cap is an f32 remedy: f64 keeps the dtype default
    if _DTYPES[str(cfg.solver.dtype)] != torch.float32:
        ratio_cap = None
    return qp_iters, k_stiff, stiff_iters, ratio_cap


# every solver knob the step reads, (default, the values it takes); any other
# value raises rather than being dropped.  kernel 2's routes on the card: f32
# IEEE on the CUDA cores (the JAX kernel's HIGHEST), f32x3 3xTF32 on the
# tensor cores (its bf16x3 _dot3), bf16 and mixed on the bf16 tensor cores;
# the CPU runs the exact plain version for every mode
KNOBS = {"qp_backend": ("auto", ("auto", "condensed", "riccati")),
         "chol_impl": ("auto", CHOL_IMPLS),
         "lin_impl": ("auto", ("auto", "pallas", "xla")),
         "fused_sdf": (True, (True, False)),
         "sdf_fused_dtype": ("f32x3", sdf_fused.MODES),
         "qp_data_bf16": (False, (False, True)),
         "qp_compute_dtype": (None, (None, *_DTYPES))}


def _check_supported(cfg):
    s = cfg.solver
    bad = {k: s.get(k, d) for k, (d, ok) in KNOBS.items() if s.get(k, d) not in ok}
    if bad:
        raise ValueError(f"unknown solver settings {bad}; the values taken: "
                         f"{ {k: ok for k, (_, ok) in KNOBS.items()} }")
    if str(s.dtype) not in _DTYPES:
        raise ValueError(f"unsupported solver dtype {s.dtype!r}")


def bf16_round(t):
    """t rounded to bfloat16 (nearest, ties to even) and back to its dtype:
    the QP data under ``solver.qp_data_bf16`` (JAX sqp.py:631-637)."""
    return t.to(torch.bfloat16).to(t.dtype)


def make_rti_step(ocp: OcpSpec, cfg, budget: str = "cold", with_evals: bool = True):
    """Build the batched RTI step: step(state, inputs) -> SolveResult.

    budget selects the QP iteration schedule ("cold", "warm" or "steady").
    with_evals=False skips the per-node diagnostics (``ocp.eval_names``: the
    "sdf" row is a second NeuralDF pass over all N+1 nodes)."""
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    _check_supported(cfg)
    dtype = _DTYPES[str(cfg.solver.dtype)]
    dev = ocp.device
    if dev.type == "cuda" and dtype != torch.float32:
        raise NotImplementedError("the CUDA kernels run float32 only")
    qp_iters, k_stiff, stiff_iters, ratio_cap = _budget_knobs(cfg, budget)
    nz = N * nu
    nh, nhN = ocp.nh, ocp.nhN
    layout = ocp.layout
    kkt_tol = cfg.solver.get("kkt_tol", None)
    mu0, box_margin = float(cfg.solver.barrier_init), float(cfg.solver.box_margin)
    dual_ws = bool(cfg.solver.get("dual_warm_start", False))
    ir_steps = int(cfg.solver.get("ir_steps", 0))
    chol_impl = str(cfg.solver.get("chol_impl", "auto"))
    use_riccati = resolve_qp_backend(cfg, N) == "riccati"
    # lin_impl 'xla': the linearization by torch.func through RK4 and the
    # plain condensing recursion, no kernel 1, 9 or 3 (JAX sqp.py:283-320)
    lin_xla = str(cfg.solver.get("lin_impl", "auto")) == "xla"
    qp_bf16 = bool(cfg.solver.get("qp_data_bf16", False))
    compute_dtype = cfg.solver.get("qp_compute_dtype", None)
    compute_dtype = _DTYPES[str(compute_dtype)] if compute_dtype else None

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    dt = t(ocp.dt)
    scale = t(ocp.cost_scaling)
    lbu, ubu = t(ocp.lbu), t(ocp.ubu)
    lm = float(ocp.lm_reg)
    lh, uh, zl, Zl = t(ocp.lh), t(ocp.uh), t(ocp.zl), t(ocp.Zl)
    lhN, uhN, zlN, ZlN = t(ocp.lhN), t(ocp.uhN), t(ocp.zlN), t(ocp.ZlN)
    z1_stage = (zl.expand(N, nh) * scale[:N, None]).reshape(N * nh)
    z2_stage = (Zl.expand(N, nh) * scale[:N, None]).reshape(N * nh)
    lh_all = torch.cat([lh.repeat(N), lhN])
    uh_all = torch.cat([uh.repeat(N), uhN])
    z1_all = torch.cat([z1_stage, zlN])
    z2_all = torch.cat([z2_stage, ZlN])

    # the network in the solver dtype, as a module for the rows that read it
    # (differentiated by torch.func, as in JAX) and evals; the stage SDF row's
    # value and position gradient on its fast path (JAX sqp.py's sdf_fast):
    # kernel 2 by sdf_fused_dtype for a res='full' network with fused_sdf on,
    # else the autodiff row, as the JAX package takes without a fused
    # value+grad (ops/sdf_fused.py:337-339, utils/accuracy.py:165-172)
    net = value_grad = None
    sdf_fast = ocp.sdf_row_batch is not None
    if ocp.sdf is not None:
        net = copy.deepcopy(ocp.sdf).to(dtype).requires_grad_(False)
    if sdf_fast:
        if bool(cfg.solver.get("fused_sdf", True)) and ocp.sdf.res == "full":
            packed = sdf_fused.pack_neural_df_params(ocp.sdf, dtype)
            sdf_mode = str(cfg.solver.get("sdf_fused_dtype", "f32x3"))
            value_grad = lambda pos, latent: sdf_fused.sdf_value_grad(packed, pos, latent,
                                                                      mode=sdf_mode)
        else:
            value_grad = autodiff_value_grad(net)

    # the stage rows torch.func differentiates: on the SDF row's fast path
    # the others (FoV and extension rows), else the whole stack; with few
    # rows by reverse mode (JAX sqp.py:271, 319-341)
    if sdf_fast:
        cheap, cheap_idx = ocp.h_stage_cheap, list(ocp.cheap_stage_indices)
    else:
        cheap = (lambda x, u, p: ocp.h_stage(x, u, p, net)) if nh else None
        cheap_idx = list(range(nh))
    n_cheap = len(cheap_idx)
    if cheap_idx == list(range(n_cheap)):  # a leading run of rows: a slice, not an index
        cheap_idx = slice(0, n_cheap)
    h_jac = jacrev if 0 < nh < (nx + nu) // 2 else jacfwd

    def pos_node(x3, x_rest, u, p):
        return cheap(torch.cat([x3, x_rest], -1), u, p)

    # linearization: kernel 1 where the model has a component-form residual
    # and the OCP's residual is the model's, else kernel 9 for x+, A, B and
    # torch.func for the residual rows, as the JAX step (sqp.py:282-310)
    use_lin_y = ocp.model.y_lanes is not None and ocp.ny == ocp.model.ny and not lin_xla

    def y_node(x, u, p):
        y_fn = lambda xv, uv: ocp.y(xv, uv, p, net)
        Jyx, Jyu = jacfwd(y_fn, argnums=(0, 1))(x, u)
        return y_fn(x, u), Jyx, Jyu

    y_lin = vmap(y_node)
    if ocp.cheap_rows_pos_only:  # x[:3] alone: 3 forward tangents
        cheap_jac = vmap(jacfwd(pos_node, argnums=0))
    elif n_cheap:
        cheap_jac = vmap(h_jac(cheap, argnums=(0, 1)))
    yN_jac = vmap(jacfwd(ocp.yN, argnums=0))
    hN_jac = None
    if nhN:
        jacN = jacrev if nhN < nx // 2 else jacfwd
        hN_jac = vmap(jacN(lambda x, p: ocp.h_term(x, p, net), argnums=0))

    def step(state: SolverState, inp: SolveInputs) -> SolveResult:
        with span("nmpc.step"):
            return _step(state, inp)

    def _step(state: SolverState, inp: SolveInputs) -> SolveResult:
        # ---- 1. per-node linearization: kernel 1, or kernel 9 + torch.func ----
        with span("nmpc.step.lin"):
            X = state.X.to(dtype)
            U = state.U.to(dtype)
            x0 = inp.x0.to(dtype)
            p = inp.p.to(dtype)
            W, WN = inp.W.to(dtype), inp.WN.to(dtype)
            B = X.shape[0]
            M = B * N
            XN_, PN_ = X[:, :N].reshape(M, nx), p[:, :N].reshape(M, -1)
            UN_, dtN_ = U.reshape(M, nu).contiguous(), dt.repeat(B).contiguous()
            yref = inp.yref.to(dtype).reshape(M, -1).contiguous()
            if use_lin_y:
                x_next, A, Bm, res, Jyx, Jyu = lin_kernels.lin_y_sens(
                    ocp.model, layout, XN_.contiguous(), UN_, dtN_, PN_, yref)
            else:
                erk4_sens = lin_kernels.erk4_sens_plain if lin_xla else lin_kernels.erk4_sens
                x_next, A, Bm = erk4_sens(ocp.model, XN_.contiguous(), UN_, dtN_)
                y_val, Jyx, Jyu = y_lin(XN_, UN_, PN_)
                res = y_val - yref
            ny = res.shape[-1]
            x_next = x_next.reshape(B, N, nx)
            A, Bm = A.reshape(B, N, nx, nx), Bm.reshape(B, N, nx, nu)
            res, Jyx = res.reshape(B, N, ny), Jyx.reshape(B, N, ny, nx)
            Jyu = Jyu.reshape(B, N, ny, nu)

        # ---- constraint rows: the FoV rows by jacfwd over x[:3] and the sdf
        # row by kernel 2 on its fast path, else by torch.func ----
        with span("nmpc.step.rows"):
            h_val = torch.zeros(M, nh, dtype=dtype, device=dev)
            Jhx = torch.zeros(M, nh, nx, dtype=dtype, device=dev)
            Jhu = torch.zeros(M, nh, nu, dtype=dtype, device=dev)
            if n_cheap:
                h_val[:, cheap_idx] = cheap(XN_, UN_, PN_)
                if ocp.cheap_rows_pos_only:  # (M, n_cheap, 3)
                    Jhx[:, cheap_idx, :3] = cheap_jac(XN_[:, :3], XN_[:, 3:], UN_, PN_)
                else:
                    Jhx[:, cheap_idx], Jhu[:, cheap_idx] = cheap_jac(XN_, UN_, PN_)
            if sdf_fast:
                h_sdf, dhdx3 = ocp.sdf_row_batch(XN_, PN_, value_grad)
                h_val[:, ocp.sdf_stage_idx] = h_sdf.to(dtype)
                Jhx[:, ocp.sdf_stage_idx, :3] = dhdx3.to(dtype)
            h_val, Jhx = h_val.reshape(B, N, nh), Jhx.reshape(B, N, nh, nx)
            Jhu = Jhu.reshape(B, N, nh, nu)
            defect = x_next - X[:, 1:]

        # ---- terminal rows ----
        with span("nmpc.step.terminal"):
            xN, pN = X[:, N], p[:, N]
            resN = ocp.yN(xN, pN) - inp.yrefN.to(dtype)
            JxN = yN_jac(xN, pN)
            if nhN:
                hN_val, JhxN = ocp.h_term(xN, pN, net), hN_jac(xN, pN)
            else:
                hN_val, JhxN = X.new_zeros(B, 0), X.new_zeros(B, 0, nx)

        if use_riccati:
            # ---- stage-structured (Riccati) backend: no condensing (its span
            # holds the initial-state defect alone, so that both backends show
            # the same stages); LM as lm I on the stage Hessians and no linear
            # term (JAX :450-494) ----
            with span("nmpc.step.condense"):
                e0 = x0 - X[:, 0]
            with span("nmpc.step.gram"):
                Ws = W * scale[:N, None]
                JyxW = Jyx.transpose(-1, -2) * Ws[:, :, None, :]  # (B, N, nx, ny)
                JyuW = Jyu.transpose(-1, -2) * Ws[:, :, None, :]
                JxNW = JxN.transpose(-1, -2) * WN[:, None, :]
                eye_x = torch.eye(nx, dtype=dtype, device=dev)
                sqd = StageQpData(
                    Q=torch.cat([JyxW @ Jyx, (JxNW @ JxN)[:, None]], 1) + lm * eye_x,
                    q=torch.cat([(JyxW @ res[..., None])[..., 0],
                                 (JxNW @ resN[..., None])[:, None, :, 0]], 1),
                    R=JyuW @ Jyu + lm * torch.eye(nu, dtype=dtype, device=dev),
                    r=(JyuW @ res[..., None])[..., 0], Ssu=JyuW @ Jyx,
                    A=A, B=Bm, b=defect, e0=e0, Cx=Jhx, Cu=Jhu, c=h_val,
                    lh=lh.expand(B, -1), uh=uh.expand(B, -1),
                    z1=z1_stage.reshape(N, nh).expand(B, -1, -1),
                    z2=z2_stage.reshape(N, nh).expand(B, -1, -1),
                    CxN=JhxN, cN=hN_val, lhN=lhN.expand(B, -1), uhN=uhN.expand(B, -1),
                    z1N=zlN.expand(B, -1), z2N=ZlN.expand(B, -1), lb=lbu - U, ub=ubu - U)
            with span("nmpc.step.qp"):
                rres = solve_qp_riccati(sqd, iters=qp_iters, mu0=mu0, box_margin=box_margin,
                                        k_stiff=k_stiff, stiff_iters=stiff_iters,
                                        ratio_cap_override=ratio_cap)
            with span("nmpc.step.update"):
                return finish(X, U, rres.ddx, rres.ddu, rres.kkt_residual, rres.complementarity,
                              state.qp_duals, p)

        # ---- 2. condensing: kernel 3; without constraint rows (enable_sdf
        # off) or under lin_impl 'xla' the plain recursion, as JAX takes its
        # non-kernel condensing at nh = 0 (sqp.py:501): kernel 3 needs nh >= 1 ----
        with span("nmpc.step.condense"):
            e0 = x0 - X[:, 0]
            condense = (condense_kernel.condense if nh and not lin_xla
                        else condense_kernel.condense_plain)
            e_st, E_st, eN, EN, G, res_c, C_st, c_st = condense(
                *[v.contiguous() for v in (A, Bm, defect, e0, Jyx, Jyu, res, Jhx, Jhu, h_val)])

        # ---- 3. condensed Hessian / gradient: one Gram product ----
        with span("nmpc.step.gram"):
            Ws = W * scale[:N, None]
            GN = JxN @ EN  # (B, nyN, nz)
            resN_c = resN + (JxN @ eN[..., None])[..., 0]
            # Levenberg-Marquardt rows (acados convention): 0.5 lm ||e_k + E_k dz||^2
            E_all = torch.cat([E_st, EN[:, None]], 1)  # (B, N+1, nx, nz)
            e_all = torch.cat([e_st, eN[:, None]], 1)  # (B, N+1, nx)
            M_rows = torch.cat([G.reshape(B, N * ny, nz), GN,
                                E_all.reshape(B, (N + 1) * nx, nz)], 1)
            w_rows = torch.cat([Ws.reshape(B, N * ny), WN,
                                torch.full((B, (N + 1) * nx), lm, dtype=dtype, device=dev)], 1)
            r_rows = torch.cat([(Ws * res_c).reshape(B, N * ny), WN * resN_c,
                                lm * e_all.reshape(B, (N + 1) * nx)], 1)
            H, g = gram(M_rows, w_rows, r_rows, lm, dtype)

            C = torch.cat([C_st.reshape(B, N * nh, nz), JhxN @ EN], 1)
            c0 = torch.cat([c_st.reshape(B, N * nh), hN_val + (JhxN @ eN[..., None])[..., 0]], 1)
            if qp_bf16:  # H and C stored in bf16, every computation in the solver dtype
                H, C = bf16_round(H), bf16_round(C)
            qp = QpData(
                H=H, g=g, C=C, c0=c0,
                lh=lh_all.expand(B, -1), uh=uh_all.expand(B, -1),
                z1=z1_all.expand(B, -1), z2=z2_all.expand(B, -1),
                lb=(lbu - U).reshape(B, nz), ub=(ubu - U).reshape(B, nz),
            )

        # ---- 4. QP: kernel 4 (two phases) or kernels 5-8 (composed) ----
        with span("nmpc.step.qp"):
            qp_res = solve_qp(qp, iters=qp_iters, mu0=mu0, box_margin=box_margin,
                              k_stiff=k_stiff, stiff_iters=stiff_iters,
                              ratio_cap_override=ratio_cap,
                              warm_duals=state.qp_duals if dual_ws else None,
                              ir_steps=ir_steps, chol_impl=chol_impl, compute_dtype=compute_dtype)
            dz = qp_res.dz

        # ---- 5. linear trajectory update + NaN guard ----
        with span("nmpc.step.update"):
            # under a qp_compute_dtype dz comes in it, and the update promotes (JAX's einsum)
            E_all = E_all.to(torch.promote_types(E_all.dtype, dz.dtype))
            dX = e_all + (E_all @ dz[:, None, :, None])[..., 0]
            return finish(X, U, dX, dz.reshape(B, N, nu), qp_res.kkt_residual,
                          qp_res.complementarity,
                          qp_res.duals if state.qp_duals is not None else None, p)

    def finish(X, U, dX, dU, kkt_residual, complementarity, duals, p):
        """The trajectory update, the NaN guard and the status (both QP
        backends, JAX sqp.py:361-394)."""
        U_new, X_new = U + dU, X + dX
        bad = ~(torch.isfinite(U_new).flatten(1).all(1) & torch.isfinite(X_new).flatten(1).all(1))
        status = torch.where(bad, STATUS_NAN, STATUS_OK).to(torch.int32)
        if kkt_tol is not None:
            status = torch.where((status == STATUS_OK) & (kkt_residual > kkt_tol),
                                 STATUS_NOT_CONVERGED, status).to(torch.int32)
        U_new = torch.where(bad[:, None, None], U, U_new)
        X_new = torch.where(bad[:, None, None], X, X_new)
        evals = None
        if with_evals and ocp.eval_fn is not None:
            evals = ocp.eval_fn(X_new, torch.cat([U_new, U_new[:, -1:]], 1), p, net)
        return SolveResult(state=SolverState(X=X_new, U=U_new, qp_duals=duals),
                           u0=U_new[:, 0], status=status, kkt_residual=kkt_residual,
                           qp_complementarity=complementarity, evals=evals)

    n_sqp = int(cfg.solver.sqp_iters)

    def multi_step(state: SolverState, inp: SolveInputs) -> SolveResult:
        """cfg.solver.sqp_iters Gauss-Newton iterations (1 = RTI)."""
        result = step(state, inp)
        for _ in range(n_sqp - 1):
            result = step(result.state, inp)
        return result

    return multi_step
