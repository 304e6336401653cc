"""Reference generation: ``Ref``, ``Waypoint`` and the ``RefGen`` sampler.

Host-side numpy, counterpart of sdf_nmpc_tpu/ref_gen.py (:84-220): the hover
reference at x0, the arc-length resampling of a waypoint polyline at the
vref spacing with stop-and-turn and the four yaw modes, and the joystick
velocity / yaw-rate reference.
"""

from __future__ import annotations

import copy

import numpy as np


def _yaw2quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(0.5 * yaw), 0.0, 0.0, np.sin(0.5 * yaw)])


def _quat2yaw(q) -> float:
    w, x, y, z = (float(v) for v in q)
    return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))


class Ref:
    """Single-node reference: pose/velocity targets + active tracking weights."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.p = np.zeros(3)
        self.q = np.array([1.0, 0.0, 0.0, 0.0])
        self.v = np.zeros(3)
        self.wz = 0.0
        self.use_constrained_weights(False)

    def use_constrained_weights(self, constrained: bool):
        """Select set_const_on when constraints are active, else set_const_off."""
        ws = (self.cfg.mpc.weights.set_const_on if constrained
              else self.cfg.mpc.weights.set_const_off)
        self.Wp = np.asarray(ws.pos, dtype=float)
        self.Wq = np.asarray(ws.att, dtype=float)
        self.Wv = np.asarray(ws.vel, dtype=float)
        self.Ww = np.asarray(ws.rates, dtype=float)
        self.Wa = float(ws.acc)
        return self

    @classmethod
    def from_state(cls, cfg, x):
        """Ref tracking the given state."""
        ref = cls(cfg)
        ref.p = np.asarray(x[:3], dtype=float)
        ref.q = np.asarray(x[3:7], dtype=float)
        ref.v = np.asarray(x[7:10], dtype=float)
        ref.wz = float(x[12]) if len(x) > 12 else 0.0
        return ref

    def hover_at_state(self, x):
        """In-place hover reference at a state."""
        self.p = np.asarray(x[:3], dtype=float)
        self.q = _yaw2quat(_quat2yaw(x[3:7]))
        self.v = np.zeros(3)
        self.wz = 0.0
        return self


class Waypoint:
    def __init__(self, p, q=(1, 0, 0, 0)):
        self.p = np.array(p, dtype=float)
        self.q = np.array(q, dtype=float)

    def __str__(self):
        return f"{self.p}, yaw={_quat2yaw(self.q):.3f}"


class RefGen:
    """Per-node reference lists for the controller (N or N+1 Refs)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.x0 = None
        self.ref = Ref(cfg)
        self.force_yaw_current = self.cfg.ref.yaw_mode == "current"

    def set_x0(self, x0):
        self.x0 = np.asarray(x0, dtype=float)

    def from_x0(self):
        """Hover reference at the current state."""
        ref = copy.copy(self.ref)
        ref.p = self.x0[:3]
        ref.q = _yaw2quat(_quat2yaw(self.x0[3:7]))
        ref.v = np.zeros(3)
        ref.wz = 0.0
        return [ref] * self.cfg.mpc.N

    def _yaw_toward(self, path_p, path_q):
        """Stop-and-turn target yaw for the first segment."""
        yaw_r = _quat2yaw(path_q[0])
        if self.cfg.ref.yaw_mode == "ref":
            yaw_r = _quat2yaw(path_q[1])
        elif self.cfg.ref.yaw_mode == "align":
            dxy = path_p[1][:2] - self.x0[:2]
            if np.linalg.norm(dxy) > self.cfg.ref.yaw_align_dmin:
                yaw_r = np.arctan2(dxy[1], dxy[0])
            yaw_r += self.cfg.ref.align_yaw_offset
        return yaw_r

    def gen_ref_list_wps(self, wps):
        """Arc-length-resampled waypoint reference, padded to N+1 nodes."""
        self.ref = Ref(self.cfg)
        trajectory = []
        path_p = np.vstack([self.x0[:3]] + [wp.p for wp in wps])
        path_q = np.vstack([self.x0[3:7]] + [wp.q for wp in wps])
        path_yaw = [_quat2yaw(q) for q in path_q]

        # stop-and-turn: a large yaw error commands a pure rotation first
        if self.cfg.ref.stop_and_turn.enable:
            yaw_r = self._yaw_toward(path_p, path_q)
            if abs(path_yaw[0] - yaw_r) > self.cfg.ref.stop_and_turn.dang_min:
                ref = copy.copy(self.ref)
                ref.p = self.x0[:3]
                ref.v = np.zeros(3)
                ref.q = _yaw2quat(yaw_r)
                return [ref] * self.cfg.mpc.N

        distances = np.linalg.norm(np.diff(path_p, axis=0), axis=1)
        cumulative = np.concatenate([[0.0], np.cumsum(distances)])
        total_distance = cumulative[-1]
        if total_distance > 1e-3:
            vref = min(self.cfg.ref.vref, total_distance)  # overshoot heuristic
            spacing = self.cfg.mpc.T / self.cfg.mpc.N * vref
            for d in np.arange(0, total_distance, spacing):
                seg = int(np.searchsorted(cumulative, d)) - 1
                seg = max(0, min(seg, len(distances) - 1))
                direction = (path_p[seg + 1] - path_p[seg]) / distances[seg]
                ref = copy.copy(self.ref)
                ref.p = path_p[seg] + direction * (d - cumulative[seg])
                ref.v = direction * vref
                if self.force_yaw_current:
                    ref.q = path_q[0]
                elif self.cfg.ref.yaw_mode == "ref":
                    ref.q = _yaw2quat(path_yaw[seg + 1])
                elif self.cfg.ref.yaw_mode == "align":
                    dxy = path_p[1][:2] - self.x0[:2]
                    if np.linalg.norm(dxy) > self.cfg.ref.yaw_align_dmin:
                        ref.q = _yaw2quat(np.arctan2(ref.v[1], ref.v[0])
                                          + self.cfg.ref.align_yaw_offset)
                    else:
                        ref.q = path_q[0]
                else:  # 'zero'
                    ref.q = np.array([1.0, 0.0, 0.0, 0.0])
                trajectory.append(ref)
                if len(trajectory) > self.cfg.mpc.N:
                    break

        while len(trajectory) <= self.cfg.mpc.N:  # hold the endpoint
            ref = copy.copy(self.ref)
            ref.p = trajectory[-1].p if trajectory else path_p[-1]
            ref.q = trajectory[-1].q if trajectory else path_q[-1]
            trajectory.append(ref)
        return trajectory

    def gen_ref_joystick(self, vwref):
        """Velocity / yaw-rate reference from normalized (vx, vy, vz, wz)."""
        ref = copy.copy(self.ref)
        ref.v = np.asarray(vwref[:3], dtype=float) * self.cfg.ref.vref
        ref.wz = float(vwref[3]) * self.cfg.ref.wzref
        if self.force_yaw_current:
            ref.q = _yaw2quat(_quat2yaw(self.x0[3:7]))
        elif self.cfg.ref.yaw_mode == "align":
            vxy = ref.v[:2]
            if np.linalg.norm(vxy) > self.cfg.ref.yaw_align_dmin:
                ref.q = _yaw2quat(np.arctan2(vxy[1], vxy[0]))
            else:
                ref.q = _yaw2quat(_quat2yaw(self.x0[3:7]))
        else:
            ref.q = np.array([1.0, 0.0, 0.0, 0.0])
        trajectory = []
        for i in range(self.cfg.mpc.N + 1):
            node = copy.copy(ref)
            node.p = self.x0[:3] + ref.v * i * self.cfg.mpc.T / self.cfg.mpc.N
            trajectory.append(node)
        return trajectory
