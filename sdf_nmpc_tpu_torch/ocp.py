"""OCP assembly: a quad model, the neural-SDF constraint and the FoV rows.

Counterpart of sdf_nmpc_tpu/ocp.py ``build_ocp`` for the flags BASELINE
configs 1 and 4 run: enable_sdf off (config 1, the obstacle-free waypoint
NMPC: no constraint rows, nh = nhN = 0), or enable_sdf and sdf_constraint on
(config 4); sdf_cost, recursive feasibility and stability off, vfov_constraint
either way, any sensor fov.  Any other flag raises.  Stage constraint rows
are [hfov, vfov, sdf], the hfov row only for hfov < 3.14 (an omnidirectional
sensor has none) and the vfov row only with vfov_constraint: the FoV rows are
cheap trigonometric functions of the position (``h_stage_cheap``, None when
there are none), the SDF row goes through ``sdf_row_batch``, which takes the
NeuralDF value and position gradient of all nodes from ONE batched call
(kernel 2 on CUDA, or the autodiff row) and chains the gradient through the
camera transform.  Terminal rows are the same rows on the plain module.

Soft rows use the exact penalty elimination of the JAX package: for
l <= c(z) <= u with slack weights (z1, z2) the slack QP equals adding
z1 max(v, 0) + 0.5 z2 max(v, 0)^2 of the violation v to the objective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import resolve_device
from .config import sensor_extrinsics
from .models import make_model
from .models.base import ModelSpec
from .params import ParamLayout


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
    ny: int
    nyN: int
    y: Callable  # y(x, u, p) -> (..., ny)
    yN: Callable  # yN(x, p) -> (..., nyN)
    nh: int
    nhN: int
    # FoV rows (x, p) -> (..., nh - 1); position-only; None without FoV rows
    h_stage_cheap: Optional[Callable]
    h_term: Optional[Callable]  # hN(x, p, net) -> (..., nhN), net: the NeuralDF; None if nhN = 0
    # (X (K, nx), P (K, np), value_grad) -> (h (K,), dh/dx[:3] (K, 3)); None without the sdf row
    sdf_row_batch: Optional[Callable]
    # unflagged sdf value (x, p, net) -> (...,), the "sdf" diagnostic; None without the SDF
    sdf_eval: Optional[Callable]
    lh: np.ndarray
    uh: np.ndarray
    zl: np.ndarray
    Zl: np.ndarray
    lhN: np.ndarray
    uhN: np.ndarray
    zlN: np.ndarray
    ZlN: np.ndarray
    lbu: np.ndarray
    ubu: np.ndarray
    u_hover: np.ndarray
    lm_reg: float
    cost_scaling: np.ndarray  # (N+1,) = [dt_0..dt_{N-1}, 1]
    sdf_stage_idx: Optional[int]
    cheap_stage_indices: tuple
    sdf: Optional[torch.nn.Module]
    sdf_max_df: float
    device: torch.device
    eval_names: tuple = ("sdf",)

    @property
    def nx(self):
        return self.model.nx

    @property
    def nu(self):
        return self.model.nu

    def pack_ref(self, ref):
        """(yr, W) for one node."""
        return self.model.formate_ref(ref, n_extra=0)


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
    if slack is None:
        hard = cfg.solver.hard_slack
        return float(hard[0]), float(hard[1])
    return float(slack[0]), float(slack[1])


def _require_main_path_flags(cfg):
    fl = cfg.flags
    want = dict(sdf_cost=False, recursive_feasibility=False, stability=False)
    if bool(fl.enable_sdf):
        want["sdf_constraint"] = True
    bad = {k: bool(fl[k]) for k, v in want.items() if bool(fl[k]) != v}
    if bad:
        raise NotImplementedError(
            f"build_ocp ports the flags of BASELINE configs 1 and 4 only; unsupported: {bad} "
            "(the formulation extras are queued in ROADMAP.md)")


def _nosdf_ocp(cfg, model, layout, dt, dev) -> OcpSpec:
    """enable_sdf off (BASELINE config 1): no constraint rows."""
    empty = np.zeros(0)
    return OcpSpec(
        model=model, layout=layout, N=cfg.mpc.N, dt=dt,
        ny=model.ny, nyN=model.nyN, y=model.y, yN=model.yN, nh=0, nhN=0,
        h_stage_cheap=None, h_term=None, sdf_row_batch=None, sdf_eval=None,
        lh=empty, uh=empty, zl=empty, Zl=empty, lhN=empty, uhN=empty, zlN=empty, ZlN=empty,
        lbu=model.lbu, ubu=model.ubu, u_hover=model.u_hover,
        lm_reg=float(cfg.mpc.lm_reg), cost_scaling=np.concatenate([dt, [1.0]]),
        sdf_stage_idx=None, cheap_stage_indices=(), sdf=None, sdf_max_df=1.0, device=dev,
        eval_names=(),
    )


def build_ocp(cfg, sdf: torch.nn.Module = None, sdf_max_df: float = 1.0,
              device="cuda") -> OcpSpec:
    """Assemble the OCP.  ``sdf`` is the NeuralDF module (its parameters on
    ``device``); the camera-frame position of the body feeds it.  With
    ``flags.enable_sdf`` off it is not used and may be None."""
    dev = resolve_device(device)
    _require_main_path_flags(cfg)
    model = make_model(cfg)
    layout = ParamLayout.from_cfg(cfg)
    dt = np.diff(shooting_nodes(cfg))
    N = cfg.mpc.N
    if not bool(cfg.flags.enable_sdf):
        return _nosdf_ocp(cfg, model, layout, dt, dev)
    if sdf is None:
        raise ValueError("enable_sdf requires an sdf module")
    if any(p.device != dev for p in sdf.parameters()):
        raise ValueError(f"the sdf module's parameters are not on {dev}")

    B_p_C, B_R_C = sensor_extrinsics(cfg)
    # the JAX package holds these two offsets as float32 constants
    b_off = np.asarray(B_R_C.T @ B_p_C, np.float32).astype(np.float64)
    fov_offset = np.asarray([cfg.mpc.fov_const_offset, 0.0, 0.0], np.float32).astype(np.float64)
    hfov_lim = cfg.sensor.hfov * cfg.mpc.fov_ratio
    vfov_lim = cfg.sensor.vfov * cfg.mpc.fov_ratio
    hfov_on = cfg.sensor.hfov < 3.14  # an omnidirectional sensor has no hfov row
    vfov_on = bool(cfg.flags.vfov_constraint)

    def const(a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def co_p_b(x, p):
        """Body position in the observation camera frame: W_R_Co^T (x - W_p_Co)."""
        R = layout.get_W_R_Co(p)
        return ((x[..., None, :3] - layout.get_W_p_Co(p)[..., None, :]) @ R)[..., 0, :]

    def fov_rows(x, p):
        c = co_p_b(x, p) + const(b_off, x) + const(fov_offset, x)
        flag = layout.get_flag(p)
        rows = []
        if hfov_on:
            rows.append(flag * torch.atan2(c[..., 1], c[..., 0]))
        if vfov_on:
            rows.append(flag * torch.atan2(c[..., 2], torch.linalg.vector_norm(c[..., :2], dim=-1)))
        return torch.stack(rows, -1)

    def sdf_eval(x, p, net):
        pos = co_p_b(x, p)
        return net(torch.cat([pos, layout.get_latent(p)], -1))[..., 0]

    fov_z1, fov_z2 = _slack_or_hard(cfg, cfg.mpc.weights.slack_fov)
    df_z1, df_z2 = _slack_or_hard(cfg, cfg.mpc.weights.slack_df)
    fov = [(-hfov_lim, hfov_lim, fov_z1, fov_z2)] if hfov_on else []
    if vfov_on:
        fov.append((-vfov_lim, vfov_lim, fov_z1, fov_z2))
    n_fov = len(fov)

    def h_term(x, p, net):
        flag = layout.get_flag(p)
        df = (flag * sdf_eval(x, p, net) + (1 - flag) * sdf_max_df)[..., None]
        return torch.cat([fov_rows(x, p), df], -1) if n_fov else df

    def sdf_row_batch(X, P, value_grad):
        R = layout.get_W_R_Co(P)  # (K, 3, 3)
        pos = co_p_b(X, P)
        vals, grads = value_grad(pos.contiguous(), layout.get_latent(P).contiguous())
        flag = layout.get_flag(P)
        h = flag * vals + (1 - flag) * sdf_max_df
        dhdx3 = flag[:, None] * (R @ grads[..., None])[..., 0]
        return h, dhdx3

    sdf_row = (cfg.robot.size.xy + cfg.mpc.bound_margin, sdf_max_df + 0.2, df_z1, df_z2)
    rows = np.array(fov + [sdf_row], dtype=np.float64)  # stage and terminal alike

    return OcpSpec(
        model=model, layout=layout, N=N, dt=dt,
        ny=model.ny, nyN=model.nyN, y=model.y, yN=model.yN,
        nh=len(rows), nhN=len(rows),
        h_stage_cheap=fov_rows if n_fov else None, h_term=h_term, sdf_row_batch=sdf_row_batch,
        sdf_eval=sdf_eval,
        lh=rows[:, 0], uh=rows[:, 1], zl=rows[:, 2], Zl=rows[:, 3],
        lhN=rows[:, 0].copy(), uhN=rows[:, 1].copy(), zlN=rows[:, 2].copy(),
        ZlN=rows[:, 3].copy(),
        lbu=model.lbu, ubu=model.ubu, u_hover=model.u_hover,
        lm_reg=float(cfg.mpc.lm_reg), cost_scaling=np.concatenate([dt, [1.0]]),
        sdf_stage_idx=n_fov, cheap_stage_indices=tuple(range(n_fov)),
        sdf=sdf, sdf_max_df=float(sdf_max_df), device=dev,
    )
