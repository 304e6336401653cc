"""Batched closed-loop simulation: the controller in the loop with its plant.

Counterpart of sdf_nmpc_tpu/sim/closed_loop.py, batch-first: a rollout
takes x0 (B, nx) and ``SolveInputs`` with a leading B, and every tick runs
one batched RTI step, the plant and the collision monitor for all B
rollouts at once (the JAX package vmaps a single-rollout
``lax.scan``).  A single scenario is B = 1.

The plant is the prediction model integrated by RK4 at the control period
T / N, optionally with a disturbance on its dynamics.  The reference is held
fixed over a rollout (the frozen-observation regime between images); with
perception in the loop each chunk of ticks takes a new observation from the
current pose first.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ocp import OcpSpec
from ..solver import SolveInputs, init_state, make_rti_step
from ..solver.integrator import erk4


class ClosedLoopResult(NamedTuple):
    xs: torch.Tensor  # (B, T+1, nx) state trajectory
    us: torch.Tensor  # (B, T, nu) applied inputs
    statuses: torch.Tensor  # (B, T) solver statuses
    min_clearance: torch.Tensor  # (B,) min scene SDF along the trajectory
    tracking_error: torch.Tensor  # (B,) final position error to the target


def _plant(ocp: OcpSpec, cfg, disturbance_fn=None):
    """plant(x (B, nx), u (B, nu), tick) -> x after one control period."""
    dt_ctrl = cfg.mpc.T / cfg.mpc.N
    f = ocp.model.f
    if disturbance_fn is None:
        return lambda x, u, k: erk4(f, x, u, dt_ctrl)
    return lambda x, u, k: erk4(lambda xv, uv: f(xv, uv) + disturbance_fn(k, xv, uv), x, u,
                                dt_ctrl)


def _result(x0, xs, us, statuses, clears, inputs) -> ClosedLoopResult:
    xs = torch.stack([x0] + xs, 1)
    target = inputs.yref[:, -1, :3]  # the final reference position
    return ClosedLoopResult(
        xs=xs, us=torch.stack(us, 1), statuses=torch.stack(statuses, 1),
        min_clearance=torch.stack(clears, 1).amin(1),
        tracking_error=torch.linalg.vector_norm(xs[:, -1, :3] - target, dim=-1))


def _clearance(scene_sdf_fn, x, scene):
    if scene_sdf_fn is None:
        return torch.full(x.shape[:1], float("inf"), dtype=x.dtype, device=x.device)
    return scene_sdf_fn(x[:, :3]) if scene is None else scene_sdf_fn(x[:, :3], scene)


def make_closed_loop(ocp: OcpSpec, cfg, n_ticks: int, scene_sdf_fn: Optional[Callable] = None,
                     disturbance_fn: Optional[Callable] = None):
    """rollout(x0 (B, nx), inputs, scene=None) -> ClosedLoopResult.

    inputs         -- SolveInputs (leading B) held fixed over the rollout.
    scene_sdf_fn   -- optional world-frame oracle for the clearance: either
                      p (B, 3) -> (B,), or (p, scene) -> (B,) when the
                      rollout is called with a ``scene`` (a Scene batch with
                      a leading B).
    disturbance_fn -- optional (tick, x, u) -> xdot perturbation added to
                      the plant's dynamics.

    Every tick runs the cold budget, as the JAX rollout does."""
    step = make_rti_step(ocp, cfg, with_evals=False)
    plant = _plant(ocp, cfg, disturbance_fn)

    def rollout(x0, inputs: SolveInputs, scene=None) -> ClosedLoopResult:
        x0 = torch.as_tensor(x0, dtype=inputs.x0.dtype, device=inputs.x0.device)
        x, st = x0, init_state(ocp, x0, x0.dtype)
        xs, us, statuses, clears = [], [], [], []
        for k in range(n_ticks):
            res = step(st, inputs._replace(x0=x))
            x = plant(x, res.u0, k)
            st = res.state
            xs.append(x)
            us.append(res.u0)
            statuses.append(res.status)
            clears.append(_clearance(scene_sdf_fn, x, scene))
        return _result(x0, xs, us, statuses, clears, inputs)

    return rollout


def _write_obs(layout, p, W_p_Co, W_R_Co, latent):
    """p (B, N+1, np) with the observation (W_p_Co (B, 3), W_R_Co (B, 3, 3),
    latent (B, L)) written into every node (JAX closed_loop.py:122-126)."""
    p = p.clone()
    B = p.shape[0]
    p[:, :, list(layout.W_p_Co)] = W_p_Co.to(p.dtype)[:, None, :]
    p[:, :, list(layout.W_R_Co)] = W_R_Co.to(p.dtype).reshape(B, 9)[:, None, :]
    p[:, :, layout.latent_start:] = latent.to(p.dtype)[:, None, :]
    return p


def make_closed_loop_perception(ocp: OcpSpec, cfg, n_chunks: int, ticks_per_chunk: int,
                                observe_fn: Callable, scene_sdf_fn: Optional[Callable] = None):
    """The closed loop with the perception cycle in it: every
    ``ticks_per_chunk`` ticks ``observe_fn(x (B, nx), scene) -> (W_p_Co
    (B, 3), W_R_Co (B, 3, 3), latent (B, L))`` (a render and an encode)
    observes from the current pose, and the observation is written into
    every node's parameters for the next chunk.

    Returns rollout(x0, inputs, scene) -> ClosedLoopResult over n_chunks *
    ticks_per_chunk ticks; ``scene_sdf_fn(p, scene)`` gives the clearance."""
    step = make_rti_step(ocp, cfg, with_evals=False)
    plant = _plant(ocp, cfg)

    def rollout(x0, inputs: SolveInputs, scene) -> ClosedLoopResult:
        x0 = torch.as_tensor(x0, dtype=inputs.x0.dtype, device=inputs.x0.device)
        x, st, p = x0, init_state(ocp, x0, x0.dtype), inputs.p.to(x0.dtype)
        xs, us, statuses, clears = [], [], [], []
        for _ in range(n_chunks):
            p = _write_obs(ocp.layout, p, *observe_fn(x, scene))
            for k in range(ticks_per_chunk):
                res = step(st, inputs._replace(x0=x, p=p))
                x = plant(x, res.u0, k)
                st = res.state
                xs.append(x)
                us.append(res.u0)
                statuses.append(res.status)
                clears.append(_clearance(scene_sdf_fn, x, scene))
        return _result(x0, xs, us, statuses, clears, inputs)

    return rollout


def summarize(results: ClosedLoopResult) -> dict:
    """Batch-level aggregates of a batch of rollouts."""
    err = results.tracking_error.double().cpu().numpy()
    clear = results.min_clearance.double().cpu().numpy()
    return {
        "n": int(err.size),
        "success_rate": float(np.mean((results.statuses == 0).all(-1).cpu().numpy())),
        "mean_tracking_error": float(np.mean(err)),
        "worst_clearance": float(np.min(clear)),
        "collision_rate": float(np.mean(clear < 0.0)),
    }
