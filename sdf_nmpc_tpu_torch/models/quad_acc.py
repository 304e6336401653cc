"""World-frame acceleration quadrotor model (``acc``), a kinematic integrator.

nx=10 (p, q, v), nu=4 = (normalized world acceleration, yaw rate), each
scaled by ``cfg.robot.limits``; dv = W_a.  Stage residual y = (p, q_e[3], v,
W_a, wz) (ny=11); terminal yN = (p, q_e[3], v) (nyN=7), gated by the flag
iff sdf+rec_feas+stability.  Its linearization runs kernel 1
(``csrc/lin_y_sens.cu``, device functions ``f_acc`` / ``y_acc``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as m
from ..params import ParamLayout
from .base import ModelSpec, kernel_consts, scale_inputs, terminal_gate_enabled


def make_model(cfg) -> ModelSpec:
    lim = cfg.robot.limits
    layout = ParamLayout.from_cfg(cfg)
    gate = terminal_gate_enabled(cfg)
    scale = (float(lim.ax), float(lim.ay), float(lim.az), float(lim.wz))

    def _split(x):
        q = x[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return x[..., :3], q, x[..., 7:]

    def f(x, u):
        _, q, v = _split(x)
        us = scale_inputs(u, scale)
        zero = torch.zeros_like(us[..., :3])
        dq = m.hamilton_prod(q, torch.cat([zero, us[..., 3:]], -1)) / 2
        return torch.cat([v, dq, us[..., :3]], -1)

    def _q_parts(x):
        qraw = x[..., 3:7]
        inv = torch.rsqrt(torch.clamp((qraw * qraw).sum(-1), min=1e-30))
        return [qraw[..., i] * inv for i in range(4)]

    def f_lanes(x, u):
        """``f`` in components."""
        q0, q1, q2, q3 = _q_parts(x)
        h = 0.5 * u[..., 3] * lim.wz
        return torch.stack([x[..., 7], x[..., 8], x[..., 9], -h * q3, h * q2, -h * q1, h * q0,
                            u[..., 0] * lim.ax, u[..., 1] * lim.ay, u[..., 2] * lim.az], -1)

    def y_lanes(x, u, q_d):
        """``y`` in components (only q_e's z-component appears in y)."""
        q0, q1, q2, q3 = _q_parts(x)
        s = torch.rsqrt(torch.clamp(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, min=1e-30))
        qi0, qi1, qi2, qi3 = q0 * s, -q1 * s, -q2 * s, -q3 * s
        qd0, qd1, qd2, qd3 = q_d.unbind(-1)
        qe3 = qd0 * qi3 + qd1 * qi2 - qd2 * qi1 + qd3 * qi0
        return torch.stack([x[..., 0], x[..., 1], x[..., 2], qe3, x[..., 7], x[..., 8],
                            x[..., 9], u[..., 0] * lim.ax, u[..., 1] * lim.ay,
                            u[..., 2] * lim.az, u[..., 3] * lim.wz], -1)

    def _qe3(x, p):
        _, q, _ = _split(x)
        return m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))[..., 3:4]

    def y(x, u, p):
        return torch.cat([x[..., :3], _qe3(x, p), x[..., 7:], scale_inputs(u, scale)], -1)

    def yN(x, p):
        out = torch.cat([x[..., :3], _qe3(x, p), x[..., 7:]], -1)
        if gate:
            out = out * layout.get_flag(p)[..., None]
        return out

    def u_to_acc(x, u, p):
        _, q, _ = _split(x)
        us = scale_inputs(u, scale)
        B_a = (m.quat2rot(q).transpose(-1, -2) @ us[..., :3, None])[..., 0]
        return torch.cat([B_a, us[..., 3:]], -1)

    def formate_ref(ref, n_extra: int = 0):
        """(yr, W) packing of one node's reference; the weights follow the
        Ref's active set."""
        yr = np.concatenate([ref.p, [0.0], ref.v, [0.0, 0.0, 0.0], [ref.wz], np.zeros(n_extra)])
        W = np.concatenate(
            [ref.Wp, ref.Wq[2:3], ref.Wv, [ref.Wa, ref.Wa, ref.Wa], [ref.Ww[2]], np.zeros(n_extra)])
        return yr, W

    return ModelSpec(
        name="quad_acc",
        nx=10,
        nu=4,
        ny=11,
        nyN=7,
        f=f,
        y=y,
        yN=yN,
        u_hover=np.zeros(4),
        lbu=np.array([-1.0, -1.0, -1.0, -1.0]),
        ubu=np.array([1.0, 1.0, 1.0, 1.0]),
        formate_ref=formate_ref,
        u_to_acc=u_to_acc,
        f_lanes=f_lanes,
        y_lanes=y_lanes,
        vel_world=lambda x: x[..., 7:10],
        kernel_consts=kernel_consts(scale),
        kernel_model=("lin_y_sens", 1),
    )
