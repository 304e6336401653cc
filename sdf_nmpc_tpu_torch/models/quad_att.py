"""Roll/pitch/yawrate quadrotor model (``att``), the paper's main model.

nx=10 (p, q, v), nu=4 = (gamma=T/m, roll, pitch, wz), each normalized and
scaled by ``cfg.robot.limits``.  The commanded roll/pitch tilt a frame V that
carries only the current yaw; W_a = W_R_V V_R_B (0, 0, gamma) - g e3.
Stage residual y = (p, q_e[3], v, roll, pitch, wz, W_a[2]) (ny=11); terminal
yN = (p, q_e[3]) (nyN=4), gated by the flag iff sdf+rec_feas+stability.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as m
from ..params import ParamLayout
from .base import GRAVITY, ModelSpec, kernel_consts, scale_inputs, terminal_gate_enabled


def make_model(cfg) -> ModelSpec:
    lim = cfg.robot.limits
    layout = ParamLayout.from_cfg(cfg)
    gate = terminal_gate_enabled(cfg)
    mass = float(cfg.robot.mass)

    def _split(x):
        q = x[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return x[..., :3], q, x[..., 7:]

    scale = (float(lim.gamma), float(lim.roll), float(lim.pitch), float(lim.wz))

    def _scaled(u):
        """(gamma, roll, pitch, wz): u times the limits."""
        return scale_inputs(u, scale).unbind(-1)

    def _wrb_wa(q, u):
        gamma, roll, pitch, _ = _scaled(u)
        theta_z = torch.atan2(q[..., 3], q[..., 0])
        zero = torch.zeros_like(theta_z)
        qyaw = torch.stack([torch.cos(theta_z), zero, zero, torch.sin(theta_z)], -1)
        V_R_B = m.euler2rot(torch.stack([roll, pitch, torch.zeros_like(roll)], -1))
        W_R_B = m.quat2rot(qyaw) @ V_R_B
        zg = torch.zeros_like(gamma)
        thrust = torch.stack([zg, zg, gamma], -1)
        g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=q.dtype, device=q.device)
        W_a = (W_R_B @ thrust[..., None])[..., 0] + g
        return W_R_B, W_a

    def f(x, u):
        _, q, v = _split(x)
        wz = _scaled(u)[3]
        _, W_a = _wrb_wa(q, u)
        zero = torch.zeros_like(wz)
        dq = m.hamilton_prod(q, torch.stack([zero, zero, zero, wz], -1)) / 2
        return torch.cat([v, dq, W_a], -1)

    def f_lanes(x, u):
        """``f`` in components, with cos/sin of atan2(q3, q0) in algebraic
        form: c = q0/|q03|, s = q3/|q03|."""
        qraw = x[..., 3:7]
        inv = torch.rsqrt(torch.clamp((qraw * qraw).sum(-1), min=1e-30))
        q0, q1, q2, q3 = (qraw[..., i] * inv for i in range(4))
        gamma = u[..., 0] * lim.gamma
        roll = u[..., 1] * lim.roll
        pitch = u[..., 2] * lim.pitch
        wz = u[..., 3] * lim.wz
        rinv = torch.rsqrt(torch.clamp(q0 * q0 + q3 * q3, min=1e-30))
        c, s = q0 * rinv, q3 * rinv
        r00 = c * c - s * s
        r10 = 2 * c * s
        cr, sr = torch.cos(roll), torch.sin(roll)
        cp, sp = torch.cos(pitch), torch.sin(pitch)
        b0 = gamma * (cr * sp)
        b1 = gamma * (-sr)
        b2 = gamma * (cr * cp)
        a0 = r00 * b0 - r10 * b1
        a1 = r10 * b0 + r00 * b1
        a2 = (c * c + s * s) * b2 - GRAVITY
        h = 0.5 * wz
        return torch.stack([x[..., 7], x[..., 8], x[..., 9], -h * q3, h * q2,
                            -h * q1, h * q0, a0, a1, a2], -1)

    def y_lanes(x, u, q_d):
        """``y`` in components (only q_e's z-component appears in y)."""
        qraw = x[..., 3:7]
        inv = torch.rsqrt(torch.clamp((qraw * qraw).sum(-1), min=1e-30))
        q0, q1, q2, q3 = (qraw[..., i] * inv for i in range(4))
        s = torch.rsqrt(torch.clamp(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, min=1e-30))
        qi0, qi1, qi2, qi3 = q0 * s, -q1 * s, -q2 * s, -q3 * s
        qd0, qd1, qd2, qd3 = q_d.unbind(-1)
        qe3 = qd0 * qi3 + qd1 * qi2 - qd2 * qi1 + qd3 * qi0
        gamma = u[..., 0] * lim.gamma
        roll = u[..., 1] * lim.roll
        pitch = u[..., 2] * lim.pitch
        wz = u[..., 3] * lim.wz
        rinv = torch.rsqrt(torch.clamp(q0 * q0 + q3 * q3, min=1e-30))
        c, sy = q0 * rinv, q3 * rinv
        a2 = (c * c + sy * sy) * (gamma * torch.cos(roll) * torch.cos(pitch)) - GRAVITY
        return torch.stack([x[..., 0], x[..., 1], x[..., 2], qe3, x[..., 7], x[..., 8],
                            x[..., 9], roll, pitch, wz, a2], -1)

    def y(x, u, p):
        pos, q, v = _split(x)
        _, roll, pitch, wz = _scaled(u)
        _, W_a = _wrb_wa(q, u)
        q_e = m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))
        return torch.cat([pos, q_e[..., 3:4], v,
                          torch.stack([roll, pitch, wz, W_a[..., 2]], -1)], -1)

    def yN(x, p):
        pos, q, _ = _split(x)
        q_e = m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))
        out = torch.cat([pos, q_e[..., 3:4]], -1)
        if gate:
            out = out * layout.get_flag(p)[..., None]
        return out

    def u_to_acc(x, u, p):
        _, q, _ = _split(x)
        W_R_B, W_a = _wrb_wa(q, u)
        B_a = (W_R_B.transpose(-1, -2) @ W_a[..., None])[..., 0]
        return torch.cat([B_a, _scaled(u)[3][..., None]], -1)

    def u_to_TRPYr(x, u, p):
        return torch.stack([u[..., 0] * lim.gamma * mass, u[..., 1] * lim.roll,
                            u[..., 2] * lim.pitch, u[..., 3] * lim.wz], -1)

    def formate_ref(ref, n_extra: int = 0):
        """(yr, W) packing of one node's reference."""
        yr = np.concatenate([ref.p, [0.0], ref.v, [0.0, 0.0], [ref.wz], [0.0], np.zeros(n_extra)])
        W = np.concatenate(
            [ref.Wp, [ref.Wq[2]], ref.Wv, ref.Wq[:2], ref.Ww[2:3], [ref.Wa], np.zeros(n_extra)]
        )
        return yr, W

    return ModelSpec(
        name="quad_rollpitchyawrate",
        nx=10,
        nu=4,
        ny=11,
        nyN=4,
        f=f,
        y=y,
        yN=yN,
        u_hover=np.array([GRAVITY / lim.gamma, 0.0, 0.0, 0.0]),
        lbu=np.array([0.0, -1.0, -1.0, -1.0]),
        ubu=np.array([1.0, 1.0, 1.0, 1.0]),
        formate_ref=formate_ref,
        u_to_acc=u_to_acc,
        u_to_TRPYr=u_to_TRPYr,
        f_lanes=f_lanes,
        y_lanes=y_lanes,
        vel_world=lambda x: x[..., 7:10],
        kernel_consts=kernel_consts(scale),
        kernel_ids=(("lin_y_sens", 0), ("erk4_sens", 3)),
    )
