"""OCP assembly: a quad model, its cost residual and constraint rows.

Counterpart of sdf_nmpc_tpu/ocp.py ``build_ocp`` (:150-519), every flag:
with ``flags.enable_sdf`` the FoV rows (hfov for hfov < 3.14: an
omnidirectional sensor has none; vfov with vfov_constraint), the neural-SDF
stage and terminal row (sdf_constraint), the ``(1 - 0.5 sdf)^4`` stage cost
row at weight 20 (sdf_cost), the recursive-feasibility terminal rows
(``sdf - flag bdist(v)``, the two FoV rows of the braking end point, hard; the
terminal SDF row dropped) and the stability terminal ingredients (three hard
velocity rows and the cost row ``flag |v|^2`` at weight p_term); without it
(BASELINE config 1) no row.  Then the caller's extension rows
(``constraints.py`` builds some).  Stage rows are [hfov, vfov, sdf, extension
rows...], terminal rows [hfov, vfov, sdf or the recursive-feasibility rows,
stability rows, extension rows...].

Rows that read the network take it as their last argument (``net``: the
NeuralDF the step holds in its dtype): ``y(x, u, p, net)``,
``h_stage(x, u, p, net)``, ``h_term(x, p, net)``, ``eval_fn(x, u, p,
net)``; the caller's rows take (x, u, p) or (x, p).  Every function
broadcasts over leading batch axes.

With sdf_constraint on and sdf_cost off, the stage SDF row takes the fast
path (``sdf_row_batch``): the NeuralDF value and position gradient of all
nodes from ONE batched call (kernel 2 on CUDA, or the autodiff row),
chained through the camera transform; the other stage rows are
``h_stage_cheap`` (x, u, p), position-only without extension rows.  Under
sdf_cost the SDF reaches the stage residual, and the step differentiates the
whole stack by ``torch.func``, as the JAX package does (:447).

Soft rows use the exact penalty elimination of the JAX package: for
l <= c(z) <= u with slack weights (z1, z2) the slack QP equals adding
z1 max(v, 0) + 0.5 z2 max(v, 0)^2 of the violation v to the objective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import math as m
from . import resolve_device
from .config import sensor_extrinsics
from .models import make_model
from .models.base import GRAVITY, ModelSpec
from .params import ParamLayout
from .utils.device_consts import kept


def shooting_nodes(cfg) -> np.ndarray:
    """Uniform or front-dense shooting grid."""
    N, T = cfg.mpc.N, cfg.mpc.T
    if cfg.mpc.uniform_dt:
        return np.linspace(0.0, T, N + 1)
    n_short = cfg.mpc.nb_short_nodes
    dt_short = cfg.mpc.control_loop_time * 1e-3
    return np.hstack([
        np.linspace(0.0, dt_short * (n_short - 1), n_short),
        np.linspace(dt_short * n_short, T, N - n_short + 1),
    ])


@dataclasses.dataclass(frozen=True)
class OcpSpec:
    """Immutable OCP description consumed by the SQP solver."""

    model: ModelSpec
    layout: ParamLayout
    N: int
    dt: np.ndarray  # (N,) per-interval steps
    ny: int  # model.ny + stage cost rows
    nyN: int
    y: Callable  # y(x, u, p, net) -> (..., ny)
    yN: Callable  # yN(x, p) -> (..., nyN)
    extra_W_stage: np.ndarray  # fixed weights of the appended stage cost rows
    extra_W_term: np.ndarray  # of the terminal ones (the step reads W[:nyN], see pack_ref)
    nh: int
    nhN: int
    h_stage: Optional[Callable]  # h(x, u, p, net) -> (..., nh); None if nh = 0
    h_term: Optional[Callable]  # hN(x, p, net) -> (..., nhN); None if nhN = 0
    lh: np.ndarray
    uh: np.ndarray
    zl: np.ndarray
    Zl: np.ndarray
    lhN: np.ndarray
    uhN: np.ndarray
    zlN: np.ndarray
    ZlN: np.ndarray
    eval_fn: Optional[Callable]  # diagnostics (x, u, p, net) -> (..., neval)
    eval_names: tuple
    lbu: np.ndarray
    ubu: np.ndarray
    u_hover: np.ndarray
    lm_reg: float
    cost_scaling: np.ndarray  # (N+1,) = [dt_0..dt_{N-1}, 1]
    sdf: Optional[torch.nn.Module]
    sdf_max_df: float
    device: torch.device
    # the stage SDF row's fast path: its index among the nh stage rows, or None;
    # (X (K, nx), P (K, np), value_grad) -> (h (K,), dh/dx[:3] (K, 3))
    sdf_stage_idx: Optional[int] = None
    sdf_row_batch: Optional[Callable] = None
    # the other stage rows (x, u, p) -> (..., nh - 1) and their positions; None if none
    h_stage_cheap: Optional[Callable] = None
    cheap_stage_indices: tuple = ()
    # the cheap rows read only x[:3] and p (the FoV rows; extension rows clear
    # it): the step differentiates them with 3 position tangents
    cheap_rows_pos_only: bool = False

    @property
    def nx(self):
        return self.model.nx

    @property
    def nu(self):
        return self.model.nu

    def pack_ref(self, ref):
        """(yr, W) for one node, the appended cost rows targeting 0 at their
        fixed weights.  A terminal node takes (yr, W)[:nyN], as the JAX
        controller and accuracy workload do: the terminal cost rows' weights
        (stability's p_term) are computed but never reach the step
        (ROADMAP.md section 3)."""
        n_extra = len(self.extra_W_stage)
        yr, W = self.model.formate_ref(ref, n_extra=n_extra)
        if n_extra:
            W[-n_extra:] = self.extra_W_stage
        return yr, W


class SdfFn(torch.nn.Module):
    """A plain SDF callable ``fn(pos (..., 3), latent (..., L)) -> (...)``
    as the network module the OCP and the step take (the JAX package's
    ``build_ocp(cfg, sdf_fn=...)`` takes any such function, e.g.
    ``sim.make_scene_sdf_fn``'s scene oracle).  It is not a NeuralDF
    (``res`` 'callable'), so the step takes the autodiff row, no kernel 2.
    Tensors the callable holds keep their dtype: an f64 step on an f32
    scene promotes, as the JAX package does."""

    res = "callable"

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, inp):
        return self.fn(inp[..., :3], inp[..., 3:])[..., None]


def autodiff_value_grad(net):
    """value_grad(pos (K, 3), latent (K, L)) -> (df (K,), d df / d pos (K, 3))
    of the NeuralDF ``net`` by ``torch.func``: the vmapped value and gradient
    of the scalar network, the counterpart of the JAX package's default
    vmapped ``jax.value_and_grad`` of ``sdf_fn`` (ocp.py:423-430).  The RTI
    step takes it for a network the fused value+grad does not support (res !=
    'full') and under ``solver.fused_sdf: False``; it launches no kernel 2."""
    from torch.func import grad_and_value, vmap

    def scalar(pos, latent):
        return net(torch.cat([pos, latent], -1))[0]

    grads_values = vmap(grad_and_value(scalar))

    def value_grad(pos, latent):
        grads, vals = grads_values(pos, latent)
        return vals, grads

    return value_grad


def _slack_or_hard(cfg, slack) -> tuple[float, float]:
    """(L1, L2) penalty weights: the config's slack pair, or the hard-row
    stand-in penalty when the row is hard (slack None)."""
    if slack is None:
        hard = cfg.solver.hard_slack
        return float(hard[0]), float(hard[1])
    return float(slack[0]), float(slack[1])


def camera_frame_position(cfg, layout: ParamLayout):
    """(co_p_b, co_p_c): fn(x, p) -> the body's (camera's) position in the
    observation camera frame Co, W_R_Co^T (x[:3] - W_p_Co) (+ the sensor
    offset B_R_C^T B_p_C, held as a float32 constant as the JAX package
    does)."""
    B_p_C, B_R_C = sensor_extrinsics(cfg)
    b_off = np.asarray(B_R_C.T @ B_p_C, np.float32).astype(np.float64)

    def co_p_b(x, p):
        R = layout.get_W_R_Co(p)
        return ((x[..., None, :3] - layout.get_W_p_Co(p)[..., None, :]) @ R)[..., 0, :]

    def co_p_c(x, p):
        return co_p_b(x, p) + kept(b_off, x)

    return co_p_b, co_p_c


def _stack(fns, *args):
    return torch.stack([fn(*args) for fn in fns], -1)


def _cat(blocks, *args):
    """The rows of (fn, bounds) blocks, each fn(*args) -> (..., k), side by side."""
    outs = [fn(*args) for fn, _ in blocks]
    return outs[0] if len(outs) == 1 else torch.cat(outs, -1)


def build_ocp(cfg, sdf: torch.nn.Module = None, sdf_max_df: float = 1.0,
              bdist_coeffs: Optional[np.ndarray] = None, r_tilde: Optional[float] = None,
              extra_cost_stage: Sequence = (), extra_cost_term: Sequence = (),
              extra_const_stage: Sequence = (), extra_const_term: Sequence = (),
              extra_eval: Sequence = (), device="cuda") -> OcpSpec:
    """Assemble the OCP.

    sdf          -- the NeuralDF module (its parameters on ``device``), or a
                    callable (pos (..., 3), latent (..., L)) -> (...,) such as
                    ``sim.make_scene_sdf_fn``'s oracle (wrapped in ``SdfFn``:
                    the autodiff row, no kernel 2); the camera-frame position
                    of the body feeds it.  Required with flags.enable_sdf,
                    else unused and may be None.
    sdf_max_df   -- the network's truncation distance.
    bdist_coeffs -- 3-variate polynomial coefficients of the braking distance
                    (required with flags.recursive_feasibility).
    r_tilde      -- the stability terminal-cost constant; with
                    flags.stability and None, theory.stability's maximum.
    extra_*      -- extension rows (``constraints.py`` builds some): cost rows
                    (fn, weight), constraint rows (fn, lower, upper, z1, z2),
                    eval rows (name, fn); stage fns take (x, u, p), terminal
                    fns (x, p), each -> (...,).
    """
    dev = resolve_device(device)
    model = make_model(cfg)
    layout = ParamLayout.from_cfg(cfg)
    lim = cfg.robot.limits
    fl = cfg.flags
    dt = np.diff(shooting_nodes(cfg))
    N = cfg.mpc.N

    cost_rows_stage: list = []  # fn(x, u, p, net) -> (...,)
    cost_w_stage: list = []
    cost_rows_term: list = []  # fn(x, p) -> (...,)
    cost_w_term: list = []
    # constraint rows in blocks that share their work: (fn -> (..., k), the
    # k rows' (l, u, z1, z2)); stage fns take (x, u, p, net), terminal fns
    # (x, p, net)
    h_blocks_stage: list = []
    h_blocks_term: list = []
    eval_rows: list = []  # (name, fn(x, u, p, net))

    co_p_b, co_p_c = camera_frame_position(cfg, layout)
    # the JAX package holds this offset as a float32 constant
    fov_offset = np.asarray([cfg.mpc.fov_const_offset, 0.0, 0.0], np.float32).astype(np.float64)
    hfov_lim = cfg.sensor.hfov * cfg.mpc.fov_ratio
    vfov_lim = cfg.sensor.vfov * cfg.mpc.fov_ratio
    hfov_on = cfg.sensor.hfov < 3.14  # an omnidirectional sensor has no hfov row
    vfov_on = bool(fl.vfov_constraint)

    def hfov_of(c, p):
        return layout.get_flag(p) * torch.atan2(c[..., 1], c[..., 0])

    def vfov_of(c, p):
        return layout.get_flag(p) * torch.atan2(c[..., 2],
                                                torch.linalg.vector_norm(c[..., :2], dim=-1))

    def fov_rows(c, p, hfov=hfov_on):
        """The FoV rows of the camera-frame point c (..., 3): (..., n)."""
        rows = ([hfov_of(c, p)] if hfov else []) + ([vfov_of(c, p)] if vfov_on else [])
        return torch.stack(rows, -1)

    def cam(x, p):
        return co_p_c(x, p) + kept(fov_offset, x)

    def sdf_unflagged(x, p, net):
        return net(torch.cat([co_p_b(x, p), layout.get_latent(p)], -1))[..., 0]

    def sdf_flagged(x, p, net):
        flag = layout.get_flag(p)
        return flag * sdf_unflagged(x, p, net) + (1 - flag) * sdf_max_df

    sdf_fast = False
    if fl.enable_sdf:
        if sdf is None:
            raise ValueError("enable_sdf requires an sdf module")
        if not isinstance(sdf, torch.nn.Module):
            sdf = SdfFn(sdf)
        if any(q.device != dev for q in sdf.parameters()):
            raise ValueError(f"the sdf module's parameters are not on {dev}")

        # FoV rows (trigonometric form), stage and terminal
        fov = _slack_or_hard(cfg, cfg.mpc.weights.slack_fov)
        fov_bounds = (([(-hfov_lim, hfov_lim, *fov)] if hfov_on else [])
                      + ([(-vfov_lim, vfov_lim, *fov)] if vfov_on else []))
        if fov_bounds:
            h_blocks_stage.append((lambda x, u, p, net: fov_rows(cam(x, p), p), fov_bounds))
            h_blocks_term.append((lambda x, p, net: fov_rows(cam(x, p), p), fov_bounds))

        sdf_bounds = (cfg.robot.size.xy + cfg.mpc.bound_margin, sdf_max_df + 0.2)
        eval_rows.append(("sdf", lambda x, u, p, net: sdf_unflagged(x, p, net)))

        if fl.sdf_cost:  # (1 - 0.5 sdf)^4 at weight 20
            # sdf / 2, not 0.5 sdf: see braking_endpoint
            cost_rows_stage.append(lambda x, u, p, net: (1 - sdf_flagged(x, p, net) / 2) ** 4)
            cost_w_stage.append(20.0)

        sdf_stage_idx = None
        if fl.sdf_constraint:
            df = [(*sdf_bounds, *_slack_or_hard(cfg, cfg.mpc.weights.slack_df))]
            sdf_stage_idx = len(fov_bounds)
            h_blocks_stage.append((lambda x, u, p, net: sdf_flagged(x, p, net)[..., None], df))
            if not fl.recursive_feasibility:
                h_blocks_term.append((lambda x, p, net: sdf_flagged(x, p, net)[..., None], df))
        sdf_fast = bool(fl.sdf_constraint) and not fl.sdf_cost

        # recursive-feasibility terminal rows, through the model's vel_world
        if fl.recursive_feasibility:
            if model.vel_world is None:
                raise ValueError("recursive feasibility needs a model exposing world-frame "
                                 "velocity (ModelSpec.vel_world)")
            if bdist_coeffs is None:
                raise ValueError("recursive_feasibility requires bdist_coeffs")
            bdist_poly, _ = m.polynomial_3variate(cfg.mpc.braking_dist.degree, bdist_coeffs)
            vel_w = model.vel_world
            B_p_C, B_R_C = sensor_extrinsics(cfg)
            end_off = B_R_C.T @ B_p_C  # in the row's dtype, as the JAX package

            def braking_dist(x):
                return bdist_poly(vel_w(x))

            def rec_feas(x, p, net):
                return sdf_flagged(x, p, net) - layout.get_flag(p) * braking_dist(x)

            def braking_endpoint(x, p):
                """Camera-frame position Co_p_E of the braking stop point."""
                v = vel_w(x)
                # keepdim: under vmap a 0-dim tensor plus a Python float takes
                # a float64 tangent
                smooth_norm = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-4)
                W_p_E = x[..., :3] + braking_dist(x)[..., None] * v / smooth_norm
                R = layout.get_W_R_Co(p)
                rel = W_p_E - layout.get_W_p_Co(p)
                return (rel[..., None, :] @ R)[..., 0, :] + kept(end_off, x)

            eval_rows.append(("braking_dist", lambda x, u, p, net: braking_dist(x)))
            eval_rows.append(("rec_feas_margin",
                              lambda x, u, p, net: sdf_unflagged(x, p, net) - braking_dist(x)))
            bk = _slack_or_hard(cfg, cfg.mpc.weights.slack_brake)
            h_blocks_term.append((lambda x, p, net: rec_feas(x, p, net)[..., None],
                                  [(cfg.robot.size.xy, sdf_max_df, *bk)]))
            # the braking end point's FoV rows, hard: hfov whatever the sensor
            hard = _slack_or_hard(cfg, None)
            end_bounds = [(-hfov_lim, hfov_lim, *hard)] + (
                [(-vfov_lim, vfov_lim, *hard)] if vfov_on else [])
            h_blocks_term.append((lambda x, p, net: fov_rows(
                braking_endpoint(x, p) + kept(fov_offset, x), p, hfov=True), end_bounds))

            # stability terminal ingredients
            if fl.stability:
                h_blocks_term.append((lambda x, p, net: x[..., 7:10],
                                      [(-b, b, *hard) for b in (lim.vx, lim.vy, lim.vz)]))
                wts = cfg.mpc.weights  # the stage-cost upper bound sc_max
                max_vel_error = (2 * cfg.ref.vref) ** 2 * max(wts.set_const_off.vel)
                max_att = np.array([lim.roll, lim.pitch, lim.wz])
                att_w = np.diag(list(wts.set_const_off.att[:2])
                                + list(wts.set_const_off.rates[2:]))
                max_att_error = float(max_att @ att_w @ max_att)
                acc_w = wts.set_const_off.acc
                max_thrust_error = max(acc_w * (lim.gamma - GRAVITY) ** 2, acc_w * GRAVITY**2)
                sc_max = max_vel_error + max_att_error + max_thrust_error
                ab_min = cfg.mpc.stability.a_b_min
                dt_stab = cfg.mpc.T / cfg.mpc.N
                if r_tilde is None:
                    from .theory.stability import get_r_tilde_max

                    r_tilde = get_r_tilde_max(cfg, device=dev)
                p_term = max(r_tilde + max_vel_error, sc_max / ab_min**2 / dt_stab**2)
                # |v|^2 is rotation-invariant: the raw velocity states serve
                # body- and world-frame models alike
                cost_rows_term.append(
                    lambda x, p: layout.get_flag(p) * (x[..., 7:10] * x[..., 7:10]).sum(-1))
                cost_w_term.append(float(p_term))

    # ---- extension rows ----
    for fn, w in extra_cost_stage:
        cost_rows_stage.append(lambda x, u, p, net, _f=fn: _f(x, u, p))
        cost_w_stage.append(float(w))
    for fn, w in extra_cost_term:
        cost_rows_term.append(fn)
        cost_w_term.append(float(w))
    h_blocks_stage += [(lambda x, u, p, net, _f=r[0]: _f(x, u, p)[..., None], [tuple(r[1:])])
                       for r in extra_const_stage]
    h_blocks_term += [(lambda x, p, net, _f=r[0]: _f(x, p)[..., None], [tuple(r[1:])])
                      for r in extra_const_term]
    eval_rows += [(name, lambda x, u, p, net, _f=fn: _f(x, u, p)) for name, fn in extra_eval]

    # ---- compose ----
    def y_full(x, u, p, net):
        base = model.y(x, u, p)
        return (torch.cat([base, _stack(cost_rows_stage, x, u, p, net)], -1)
                if cost_rows_stage else base)

    def yN_full(x, p):
        base = model.yN(x, p)
        return torch.cat([base, _stack(cost_rows_term, x, p)], -1) if cost_rows_term else base

    eval_fns = [fn for _, fn in eval_rows]

    def bounds(blocks):
        arr = np.array([b for _, rows in blocks for b in rows], dtype=np.float64).reshape(-1, 4)
        return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]

    lh, uh, zl, Zl = bounds(h_blocks_stage)
    lhN, uhN, zlN, ZlN = bounds(h_blocks_term)
    nh, nhN = len(lh), len(lhN)

    # the stage SDF row's fast path: one batched value+grad of the network,
    # its position gradient chained through the camera transform,
    # dh/dx[:3] = flag W_R_Co grad
    fast = {}
    if sdf_fast:
        def sdf_row_batch(X, P, value_grad):
            R = layout.get_W_R_Co(P)  # (K, 3, 3)
            pos = co_p_b(X, P)
            vals, grads = value_grad(pos.contiguous(), layout.get_latent(P).contiguous())
            flag = layout.get_flag(P)
            h = flag * vals + (1 - flag) * sdf_max_df
            dhdx3 = flag[:, None] * (R @ grads[..., None])[..., 0]
            return h, dhdx3

        cheap = [b for b in h_blocks_stage if b[1] is not df]
        fast = dict(
            sdf_stage_idx=sdf_stage_idx, sdf_row_batch=sdf_row_batch,
            h_stage_cheap=(lambda x, u, p: _cat(cheap, x, u, p, None)) if cheap else None,
            cheap_stage_indices=tuple(i for i in range(nh) if i != sdf_stage_idx),
            # without extension rows the cheap rows are the FoV rows: x[:3] and p only
            cheap_rows_pos_only=bool(cheap) and not extra_const_stage)

    return OcpSpec(
        model=model, layout=layout, N=N, dt=dt,
        ny=model.ny + len(cost_rows_stage), nyN=model.nyN + len(cost_rows_term), y=y_full, yN=yN_full,
        extra_W_stage=np.asarray(cost_w_stage, np.float64),
        extra_W_term=np.asarray(cost_w_term, np.float64),
        nh=nh, nhN=nhN,
        h_stage=(lambda x, u, p, net: _cat(h_blocks_stage, x, u, p, net)) if nh else None,
        h_term=(lambda x, p, net: _cat(h_blocks_term, x, p, net)) if nhN else None,
        lh=lh, uh=uh, zl=zl, Zl=Zl, lhN=lhN, uhN=uhN, zlN=zlN, ZlN=ZlN,
        eval_fn=(lambda x, u, p, net: _stack(eval_fns, x, u, p, net)) if eval_fns else None,
        eval_names=tuple(name for name, _ in eval_rows),
        lbu=model.lbu, ubu=model.ubu, u_hover=model.u_hover,
        lm_reg=float(cfg.mpc.lm_reg), cost_scaling=np.concatenate([dt, [1.0]]),
        sdf=sdf if fl.enable_sdf else None, sdf_max_df=float(sdf_max_df), device=dev, **fast)
