"""Nmpc: the single-robot controller facade over the port's batched step.

Counterpart of sdf_nmpc_tpu/controller.py (:32-240): ``reset``,
``set_sdf_flag``, ``set_latent``, ``reset_latent``, ``set_x0``, ``set_ref``
/ ``set_refs``, ``solve`` -> fail count, ``get_u``, ``get_t``, the clipped
``get_cmd_acc`` / ``get_cmd_TRPYr`` / ``get_cmd_props``, ``get_matrices``,
``get_openloop_traj`` and ``eval``.  Each tick is the batched RTI step at
B=1 on the OCP's device; the host keeps the parameter and reference
matrices in numpy, as the JAX controller does.

It takes ``sdf=`` (a port NeuralDF on ``device``) where the JAX controller
takes ``sdf_fn``.  The perception arguments ``bdist_coeffs`` and
``r_tilde`` (braking-distance and recursive-feasibility rows) are not
ported and raise (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .config import sensor_extrinsics
from .models.base import GRAVITY
from .ocp import OcpSpec, build_ocp
from .params import ParamLayout
from .solver import SolveInputs, init_state, make_rti_step, shift_state
from .solver.sqp import STATUS_NAN


class Nmpc:
    """Single-robot NMPC controller with neural-SDF collision prediction."""

    def __init__(self, cfg, sdf=None, sdf_max_df: float = 1.0, bdist_coeffs=None,
                 r_tilde=None, ocp: Optional[OcpSpec] = None, device="cuda"):
        if bdist_coeffs is not None or r_tilde is not None:
            raise NotImplementedError(
                "the braking-distance and recursive-feasibility rows (bdist_coeffs, "
                "r_tilde) are not ported; they are queued in ROADMAP.md")
        self.cfg = cfg
        self.layout = ParamLayout.from_cfg(cfg)
        self.T = cfg.mpc.T
        self.N = cfg.mpc.N
        if ocp is None:
            ocp = build_ocp(cfg, sdf=sdf, sdf_max_df=sdf_max_df, device=device)
        self.ocp = ocp
        self.model = ocp.model
        # three budgets (solver/sqp.py): the first tick after reset / a fresh
        # set_x0 runs the cold budget, later warm-started ticks the warm
        # budget, and after cfg.solver.steady_after clean warm ticks the
        # steady budget; the host picks the step per tick
        self._steps = {b: make_rti_step(ocp, cfg, budget=b) for b in ("cold", "warm", "steady")}
        self._steady_after = int(cfg.solver.get("steady_after", 3))
        self._dtype = getattr(torch, str(cfg.solver.dtype))  # validated by make_rti_step

        lim = cfg.robot.limits
        # command clipping bounds (the reference controller's)
        self.cmd_acc_min = np.array([-lim.ax, -lim.ay, -lim.az, -lim.wz])
        self.cmd_acc_max = np.array([lim.ax, lim.ay, lim.az, lim.wz])
        self.cmd_TRPYr_min = np.array([0.0, -lim.roll, -lim.pitch, -lim.wz])
        self.cmd_TRPYr_max = np.array([lim.gamma, lim.roll, lim.pitch, lim.wz])
        self.cmd_props_min = np.zeros(4)
        self.cmd_props_max = np.full(4, lim.wp)
        self.cmd_TRPYr_hover = np.array([cfg.robot.mass * GRAVITY, 0, 0, 0])
        self.reset()

    # ------------------------------------------------------------------ state
    def reset(self):
        """Reset the matrices, the warm start and the flags."""
        self.x0 = None
        self.p = np.zeros((self.N + 1, self.layout.np_total))
        self.y = np.zeros((self.N, self.ocp.ny))
        self.yN = np.zeros(self.ocp.nyN)
        self.W = np.zeros((self.N, self.ocp.ny))
        self.WN = np.zeros(self.ocp.nyN)
        self.fail_count = 0
        self._solver_state = None
        self._warm_tick = False
        self._clean_warm_ticks = 0
        self._u = np.zeros(self.ocp.nu)
        self._evals = None
        self._t = 0.0
        self.set_sdf_flag(False)
        self.reset_latent()

    def set_sdf_flag(self, flag: bool):
        self.layout.set_flag(self.p, float(flag))

    def set_latent(self, latent, W_p_Bo, W_R_Bo):
        """Freeze the current camera pose and latent into all N+1 nodes."""
        B_p_C, B_R_C = sensor_extrinsics(self.cfg)
        W_R_Bo = np.asarray(W_R_Bo, dtype=float).reshape(3, 3)
        W_p_Co = W_R_Bo @ B_p_C + np.asarray(W_p_Bo, dtype=float)
        self.layout.set_camera(self.p, W_p_Co, W_R_Bo @ B_R_C)
        self.layout.set_latent(self.p, latent)

    def reset_latent(self):
        self.p[:, list(self.layout.W_p_Co)] = 0.0
        self.p[:, list(self.layout.W_R_Co)] = 0.0
        self.p[:, self.layout.latent_start:] = 0.0

    # -------------------------------------------------------------- iteration
    def set_x0(self, x0, position_safe: bool = True):
        """State feedback; the first call seeds the warm start (and, with
        cfg.solver.dual_warm_start, the QP duals).  With
        cfg.mpc.allow_dead_reck and ``position_safe=False`` the measurement
        is skipped and the controller dead-reckons on its predicted state."""
        if self.cfg.mpc.allow_dead_reck and not position_safe and self.x0 is not None:
            self.x0 = self._solver_state.X[0, 1].double().cpu().numpy()
            return
        x0 = np.asarray(x0, dtype=float)[: self.ocp.nx]
        if self.x0 is None:
            self._solver_state = init_state(
                self.ocp, x0[None], self._dtype,
                dual_warm_start=bool(self.cfg.solver.get("dual_warm_start", False)))
            self._warm_tick = False  # a fresh seed solves with the cold budget
        self.x0 = x0

    def set_ref(self, ref, k: int):
        """Write the node-k reference."""
        self.layout.set_q_d(self.p[k], ref.q)
        yr, W = self.ocp.pack_ref(ref)
        if k < self.N:
            self.y[k, :] = yr
            self.W[k, :] = W
        else:
            self.yN[:] = yr[: self.ocp.nyN]
            self.WN[:] = W[: self.ocp.nyN]

    def set_refs(self, refs):
        """Write a full reference list (up to N+1 nodes)."""
        for k, ref in enumerate(refs[: self.N + 1]):
            self.set_ref(ref, k)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a)[None], dtype=self._dtype, device=self.ocp.device)

    def solve(self) -> int:
        """One RTI tick; returns the consecutive-failure count."""
        if self.x0 is None:
            raise RuntimeError("Nmpc.solve() called before set_x0(): feed a state first")
        t0 = time.perf_counter()
        self._solver_state = shift_state(self._solver_state, int(self.cfg.mpc.shift))
        inputs = SolveInputs(x0=self._tensor(self.x0), yref=self._tensor(self.y),
                             W=self._tensor(self.W), yrefN=self._tensor(self.yN),
                             WN=self._tensor(self.WN), p=self._tensor(self.p))
        result = self._steps[self.budget](self._solver_state, inputs)
        status = int(result.status[0])
        if status != STATUS_NAN:  # NaN steps are rejected; others update the iterate
            self._solver_state = result.state
            self._u = result.u0[0].double().cpu().numpy()
            self._evals = None if result.evals is None else result.evals[0].double().cpu().numpy()
        # only a clean solve leaves a trustworthy warm trajectory: a failed
        # tick drops back to the cold budget
        if status == 0:
            self._clean_warm_ticks += 1 if self._warm_tick else 0
        else:
            self._clean_warm_ticks = 0
        self._warm_tick = status == 0
        self.fail_count = 0 if status == 0 else self.fail_count + 1
        self._t = time.perf_counter() - t0
        return self.fail_count

    @property
    def budget(self) -> str:
        """The budget the next solve runs: "cold", "warm" or "steady"."""
        if not self._warm_tick:
            return "cold"
        return "steady" if self._clean_warm_ticks >= self._steady_after else "warm"

    # ---------------------------------------------------------------- getters
    def get_u(self):
        return np.asarray(self._u).flatten()

    def get_t(self) -> float:
        """Wall-clock time of the last solve [s]."""
        return self._t

    def _clipped_cmd(self, fn, lo, hi):
        if fn is None:
            raise NotImplementedError(f"model {self.model.name!r} has no such command map")
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
        cmd = fn(t(self.x0), t(self.get_u()), t(self.p[0]))
        return np.clip(cmd.numpy().flatten(), lo, hi)

    def get_cmd_acc(self):
        return self._clipped_cmd(self.model.u_to_acc, self.cmd_acc_min, self.cmd_acc_max)

    def get_cmd_TRPYr(self):
        return self._clipped_cmd(self.model.u_to_TRPYr, self.cmd_TRPYr_min, self.cmd_TRPYr_max)

    def get_cmd_props(self):
        return self._clipped_cmd(self.model.u_to_props, self.cmd_props_min, self.cmd_props_max)

    def get_matrices(self):
        """(X (N+1, nx), U (N, nu)) trajectory matrices."""
        st = self._solver_state
        return st.X[0].double().cpu().numpy(), st.U[0].double().cpu().numpy()

    def get_openloop_traj(self):
        """[(p, q)] per node, node 0 pinned to x0."""
        X = self._solver_state.X[0].double().cpu().numpy()
        return [(self.x0[:3], self.x0[3:7])] + [(X[k, :3], X[k, 3:7])
                                                for k in range(1, self.N + 1)]

    def eval(self, k: int):
        """Diagnostics vector at node k."""
        if self._evals is None:
            return [0]
        return self._evals[k]
