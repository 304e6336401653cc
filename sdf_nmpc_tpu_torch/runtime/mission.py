"""Mission server: the reference ROS node's behavioral contract, without ROS.

Counterpart of sdf_nmpc_tpu/runtime/mission.py (:65-279), over the port's
``Nmpc``, ``RefGen`` and ``VaeRuntime``: the services ``goto / hover /
takeoff / set_yaw_mode / get_yaw_mode / set_flag / get_flag / stop``, topic-
or joystick-driven references with a low-pass smoother, waypoint pruning at
``wp_tol``, stop-and-go or sliding-window tracking, the reference and image
watchdogs, the self-reset after ``max_solver_fail`` consecutive solver
failures, and the three control interfaces (acc, TRPYr, props).

``feed_*`` are the topic subscriptions (``feed_image`` encodes on the
device, ``feed_latent`` goes to ``Nmpc.set_latent``), the service methods
mirror the ROS services one to one, and ``tick(t)`` is the control-loop
timer callback returning the clipped command.  Time is explicit (the
caller's ``t`` seconds), so the watchdogs are deterministic.
"""

from __future__ import annotations

from enum import Enum
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..math import yaw2quat
from ..ref_gen import Ref, RefGen, Waypoint


class MissionMode(Enum):
    IDLE = "idle"  # starting state: hold position, no mission active
    HOVER = "hover"  # non-moving reference at a captured pose
    WPS = "wps"  # waypoint-queue tracking (goto / topic refs)
    JOYSTICK = "joystick"  # velocity teleop


class MissionTick(NamedTuple):
    """One control-loop iteration's outputs."""

    cmd: np.ndarray  # clipped command for cfg.mission.control_interface
    u: np.ndarray  # raw optimal input u0
    mode: MissionMode
    flag_active: bool  # collision constraints actually active this tick
    fail_count: int  # consecutive solver failures
    did_reset: bool  # watchdog reset fired this tick
    ref_timed_out: bool
    img_timed_out: bool
    wps_left: int


def _wp_from_row(row) -> Waypoint:
    """[x, y, z, yaw] row (reference README.md:222 wps format) -> Waypoint."""
    row = np.asarray(row, dtype=float).ravel()
    if row.size > 3:
        q = yaw2quat(torch.tensor(float(row[3]), dtype=torch.float64)).numpy()
    else:
        q = np.array([1.0, 0.0, 0.0, 0.0])
    return Waypoint(row[:3], q)


class MissionServer:
    """Transport-agnostic mission state machine around one :class:`Nmpc`.

    Parameters
    ----------
    cfg   : FrozenConfig with a ``mission:`` section (config/default.yaml).
    nmpc  : the port's controller facade (controller.Nmpc).
    vae   : optional perception runtime (perception.VaeRuntime); required
            only when images (not latents) are fed.
    """

    def __init__(self, cfg, nmpc, vae=None):
        self.cfg = cfg
        self.nmpc = nmpc
        self.vae = vae
        self.refgen = RefGen(cfg)
        m = cfg.mission
        self.control_interface = str(m.control_interface)
        if self.control_interface not in ("acc", "TRPYr", "props"):
            raise ValueError(f"unknown control_interface {self.control_interface!r}")
        self.timeout_ref = float(m.timeout_ref)
        self.timeout_img = float(m.timeout_img)
        self.stop_and_go = bool(m.stop_and_go)
        self.wp_tol = float(m.wp_tol)
        self.joystick_lp_alpha = float(m.joystick_lp_alpha)
        self.stop()

    # ------------------------------------------------------------- services
    # One-to-one with the reference node's ROS services (README.md:249-257).

    def goto(self, wps: Optional[Sequence] = None):
        """Queue waypoints (config ``mission.wps`` when none given) and track
        them (reference README.md:250)."""
        rows = self.cfg.mission.wps if wps is None else wps
        self._wps = [w if isinstance(w, Waypoint) else _wp_from_row(w) for w in rows]
        self._mode = MissionMode.WPS

    def hover(self):
        """Non-moving reference at the current position (README.md:251)."""
        if self._x is None:
            raise RuntimeError("hover() before any feed_state()")
        self._hover_target = np.array(self._x[:7])
        self._mode = MissionMode.HOVER

    def takeoff(self):
        """Hover at current x, y and the config z (README.md:252,
        cfg.ref.zref)."""
        if self._x is None:
            raise RuntimeError("takeoff() before any feed_state()")
        tgt = np.array(self._x[:7])
        tgt[2] = float(self.cfg.ref.zref)
        self._hover_target = tgt
        self._mode = MissionMode.HOVER

    def set_yaw_mode(self, free: bool):
        """Free-yaw mode ignores the reference yaw and maintains the current
        yaw as a moving reference (README.md:253)."""
        self._yaw_free = bool(free)
        self.refgen.force_yaw_current = self._yaw_free

    def get_yaw_mode(self) -> bool:
        return self._yaw_free

    def set_flag(self, flag: bool):
        """Desired collision-constraint flag; the image watchdog can veto it
        per tick (README.md:255)."""
        self._flag_desired = bool(flag)

    def get_flag(self) -> bool:
        return self._flag_desired

    def stop(self):
        """Reset to the starting state: disable constraints, discard
        references and perception state (README.md:257)."""
        self.nmpc.reset()
        self.refgen = RefGen(self.cfg)
        self._mode = MissionMode.IDLE
        self._x = None
        self._hover_target = None
        self._wps: list[Waypoint] = []
        self._flag_desired = False
        self._yaw_free = self.refgen.force_yaw_current
        self._t_ref = -np.inf  # last streamed-reference input time
        self._t_img = -np.inf  # last image/latent input time
        self._joy = np.zeros(4)  # low-passed joystick command
        self._have_latent = False

    # --------------------------------------------------------------- inputs
    def feed_state(self, x, t: float, position_safe: bool = True):
        """State estimate (the odometry subscription)."""
        self._x = np.asarray(x, dtype=float)
        self._x_safe = bool(position_safe)
        self._t_state = float(t)
        if self._hover_target is None:
            self._hover_target = np.array(self._x[:7])

    def feed_image(self, img, W_p_B, W_R_B, t: float):
        """Depth/range image -> preprocess -> encode -> latent (the image
        subscription; robot-side VAE, README.md:75-77)."""
        if self.vae is None:
            raise RuntimeError("feed_image requires a VaeRuntime")
        self.vae.set_img(img)
        self.feed_latent(self.vae.encode().ravel(), W_p_B, W_R_B, t)

    def feed_latent(self, latent, W_p_B, W_R_B, t: float):
        """Latent + camera pose at capture time (what crosses the network in
        the reference's robot/operator-PC split)."""
        self.nmpc.set_latent(latent, W_p_B, W_R_B)
        self._t_img = float(t)
        self._have_latent = True

    def feed_ref_wps(self, wps: Sequence, t: float):
        """Streamed waypoint reference (ref_mode topic, README.md:219)."""
        self.goto(wps)
        self._t_ref = float(t)

    def feed_joystick(self, vwref, t: float):
        """Normalized (vx, vy, vz, wz) teleop command, low-pass smoothed with
        ``joystick_lp_alpha`` (README.md:224)."""
        a = self.joystick_lp_alpha
        self._joy = a * self._joy + (1.0 - a) * np.asarray(vwref, dtype=float)
        self._mode = MissionMode.JOYSTICK
        self._t_ref = float(t)

    # ----------------------------------------------------------------- loop
    def _hover_refs(self, target7):
        """(N+1) non-moving refs at a pose, with the active weight set."""
        x = np.zeros(max(10, len(self._x)))
        x[: len(self._x)] = self._x
        x[:7] = target7
        ref = Ref(self.cfg).hover_at_state(x)
        return [ref] * (self.cfg.mpc.N + 1)

    def tick(self, t: float) -> MissionTick:
        """One control-loop iteration: watchdogs -> reference -> solve ->
        clipped command (the node's timer callback)."""
        if self._x is None:
            raise RuntimeError("tick() before any feed_state()")
        self.refgen.set_x0(self._x)

        ## image watchdog gates the collision flag (README.md:215 timeout_img)
        img_fresh = (t - self._t_img) <= self.timeout_img
        flag_active = self._flag_desired and self._have_latent and img_fresh
        img_timed_out = self._flag_desired and not flag_active
        self.nmpc.set_sdf_flag(flag_active)

        ## reference watchdog: streamed modes fall back to hover at the
        ## current state (README.md:214 timeout_ref)
        ref_timed_out = False
        mode = self._mode
        if mode == MissionMode.JOYSTICK and (t - self._t_ref) > self.timeout_ref:
            ref_timed_out = True

        if mode == MissionMode.WPS:
            ## prune explored waypoints (README.md:223 wp_tol)
            while self._wps and np.linalg.norm(self._wps[0].p - self._x[:3]) < self.wp_tol:
                self._wps.pop(0)
            if not self._wps:  # queue exhausted -> hover at the last target
                self._hover_target = np.array(self._x[:7])
                self._mode = mode = MissionMode.HOVER

        if mode == MissionMode.IDLE or ref_timed_out:
            refs = self._hover_refs(np.array(self._x[:7]))
        elif mode == MissionMode.HOVER:
            refs = self._hover_refs(self._hover_target)
        elif mode == MissionMode.WPS:
            if self.stop_and_go:
                ## go to the front waypoint with zero velocity instead of a
                ## sliding window (README.md:220 stop_and_go)
                wp = self._wps[0]
                tgt = np.concatenate([wp.p, wp.q])
                refs = self._hover_refs(tgt)
            else:
                refs = self.refgen.gen_ref_list_wps(self._wps)
        else:  # JOYSTICK
            refs = self.refgen.gen_ref_joystick(self._joy)

        for ref in refs:
            ref.use_constrained_weights(flag_active)
        if len(refs) == self.cfg.mpc.N:  # from_x0-style lists: pad terminal
            refs = refs + [refs[-1]]

        self.nmpc.set_x0(self._x, position_safe=self._x_safe)
        self.nmpc.set_refs(refs)
        fails = self.nmpc.solve()

        ## self-reset after max_solver_fail consecutive failures (reference
        ## config/default.yaml:63; -1 disables)
        did_reset = False
        max_fail = int(self.cfg.mpc.max_solver_fail)
        if max_fail >= 0 and fails >= max_fail:
            self.nmpc.reset()
            self.nmpc.set_sdf_flag(flag_active)
            self.nmpc.set_x0(self._x, position_safe=True)
            self._hover_target = np.array(self._x[:7])
            self._mode = MissionMode.HOVER
            did_reset = True

        cmd = {
            "acc": self.nmpc.get_cmd_acc,
            "TRPYr": self.nmpc.get_cmd_TRPYr,
            "props": self.nmpc.get_cmd_props,
        }[self.control_interface]()

        return MissionTick(
            cmd=cmd,
            u=self.nmpc.get_u(),
            mode=mode,
            flag_active=flag_active,
            fail_count=self.nmpc.fail_count,
            did_reset=did_reset,
            ref_timed_out=ref_timed_out,
            img_timed_out=img_timed_out,
            wps_left=len(self._wps),
        )
