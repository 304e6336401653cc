"""Roll/pitch/yawrate quadrotor model with a first-order attitude lag
(``att_tau``).

The interface of ``att``, but the commanded roll and pitch act through a
first-order lag, TAU 0.12 s: dot_roll = (roll_des - roll) / TAU, mapped to
body rates by ``deuler_avel_map``; the thrust acts along the current
attitude, W_a = R (0, 0, gamma) - g e3.  y = (p, q_e[3], v, roll_des,
pitch_des, wz, W_a[2]) (ny=11), yN = (p, q_e[3]) (nyN=4), gated by the flag
iff sdf+rec_feas+stability.  Its linearization runs kernel 1
(``csrc/lin_y_sens.cu``, device functions ``f_att_tau`` / ``y_att_tau``).

The JAX package's component form spells roll and pitch with polynomial
atan2 / asin (``atan2_poly`` / ``asin_poly``), since the TPU kernel
language has no atan2.  Here ``f``, ``f_lanes`` and the CUDA device
function use the true atan2 and asin (asin of the clipped argument), with
their exact derivative rules: ``f_lanes`` differs from the JAX one by the
polynomials' ~1 ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as m
from ..params import ParamLayout
from ..utils.device_consts import kept
from .base import GRAVITY, ModelSpec, kernel_consts, scale_inputs, terminal_gate_enabled

TAU_ROLL = 0.12
TAU_PITCH = 0.12


def make_model(cfg) -> ModelSpec:
    lim = cfg.robot.limits
    layout = ParamLayout.from_cfg(cfg)
    gate = terminal_gate_enabled(cfg)
    mass = float(cfg.robot.mass)
    scale = (float(lim.gamma), float(lim.roll), float(lim.pitch), float(lim.wz))

    def _split(x):
        q = x[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return x[..., :3], q, x[..., 7:]

    def _world_acc(q, gamma):
        """(W_R_B, R (0, 0, gamma) - g e3)."""
        zero = torch.zeros_like(gamma)
        W_R_B = m.quat2rot(q)
        g = kept([0.0, 0.0, -GRAVITY], q)
        thrust = torch.stack([zero, zero, gamma], -1)
        return W_R_B, (W_R_B @ thrust[..., None])[..., 0] + g

    def f(x, u):
        _, q, v = _split(x)
        eta = m.quat2euler(q)
        us = scale_inputs(u, scale)
        _, W_a = _world_acc(q, us[..., 0])
        tau = kept([TAU_ROLL, TAU_PITCH], x)
        dot = (us[..., 1:3] - eta[..., :2]) / tau
        rates = torch.cat([dot, torch.zeros_like(dot[..., :1])], -1)
        w = (m.deuler_avel_map(eta) @ rates[..., None])[..., 0]
        dq = m.hamilton_prod(q, torch.cat([torch.zeros_like(w[..., :1]), w[..., :2],
                                           us[..., 3:]], -1)) / 2
        return torch.cat([v, dq, W_a], -1)

    def _q_parts(x):
        qraw = x[..., 3:7]
        inv = torch.rsqrt(torch.clamp((qraw * qraw).sum(-1), min=1e-30))
        return [qraw[..., i] * inv for i in range(4)]

    def f_lanes(x, u):
        """``f`` in components: quat2euler's roll and pitch rows, the third
        column of quat2rot and deuler_avel_map written out."""
        q0, q1, q2, q3 = _q_parts(x)
        gamma = u[..., 0] * lim.gamma
        roll_des, pitch_des = u[..., 1] * lim.roll, u[..., 2] * lim.pitch
        wz = u[..., 3] * lim.wz
        roll = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        pitch = torch.asin(torch.clamp(2 * (q0 * q2 - q3 * q1), -1.0, 1.0))
        a0 = gamma * (2 * (q1 * q3 + q0 * q2))
        a1 = gamma * (2 * (q2 * q3 - q0 * q1))
        a2 = gamma * (q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3) - GRAVITY
        dot_roll = (roll_des - roll) / TAU_ROLL
        dot_pitch = (pitch_des - pitch) / TAU_PITCH
        sr, cr = torch.sin(roll), torch.cos(roll)
        sp, cp = torch.sin(pitch), torch.cos(pitch)
        w0 = dot_roll + (sp * sr / cp) * dot_pitch
        w1 = cr * dot_pitch
        return torch.stack([x[..., 7], x[..., 8], x[..., 9],
                            0.5 * (-q1 * w0 - q2 * w1 - q3 * wz),
                            0.5 * (q0 * w0 + q2 * wz - q3 * w1),
                            0.5 * (q0 * w1 - q1 * wz + q3 * w0),
                            0.5 * (q0 * wz + q1 * w1 - q2 * w0), a0, a1, a2], -1)

    def y_lanes(x, u, q_d):
        """``y`` in components; W_a[2] along the current attitude."""
        q0, q1, q2, q3 = _q_parts(x)
        s = torch.rsqrt(torch.clamp(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, min=1e-30))
        qi0, qi1, qi2, qi3 = q0 * s, -q1 * s, -q2 * s, -q3 * s
        qd0, qd1, qd2, qd3 = q_d.unbind(-1)
        qe3 = qd0 * qi3 + qd1 * qi2 - qd2 * qi1 + qd3 * qi0
        gamma = u[..., 0] * lim.gamma
        a2 = gamma * (q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3) - GRAVITY
        return torch.stack([x[..., 0], x[..., 1], x[..., 2], qe3, x[..., 7], x[..., 8],
                            x[..., 9], u[..., 1] * lim.roll, u[..., 2] * lim.pitch,
                            u[..., 3] * lim.wz, a2], -1)

    def _qe3(x, p):
        _, q, _ = _split(x)
        return m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))[..., 3:4]

    def y(x, u, p):
        _, q, _ = _split(x)
        us = scale_inputs(u, scale)
        _, W_a = _world_acc(q, us[..., 0])
        return torch.cat([x[..., :3], _qe3(x, p), x[..., 7:], us[..., 1:], W_a[..., 2:]], -1)

    def yN(x, p):
        out = torch.cat([x[..., :3], _qe3(x, p)], -1)
        if gate:
            out = out * layout.get_flag(p)[..., None]
        return out

    def u_to_acc(x, u, p):
        _, q, _ = _split(x)
        us = scale_inputs(u, scale)
        W_R_B, W_a = _world_acc(q, us[..., 0])
        return torch.cat([(W_R_B.transpose(-1, -2) @ W_a[..., None])[..., 0], us[..., 3:]], -1)

    def u_to_TRPYr(x, u, p):
        return torch.stack([u[..., 0] * lim.gamma * mass, u[..., 1] * lim.roll,
                            u[..., 2] * lim.pitch, u[..., 3] * lim.wz], -1)

    def formate_ref(ref, n_extra: int = 0):
        yr = np.concatenate([ref.p, [0.0], ref.v, [0.0, 0.0], [ref.wz], [0.0], np.zeros(n_extra)])
        W = np.concatenate(
            [ref.Wp, [ref.Wq[2]], ref.Wv, ref.Wq[:2], ref.Ww[2:3], [ref.Wa], np.zeros(n_extra)])
        return yr, W

    return ModelSpec(
        name="quad_rollpitchyawrate_tau",
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
        kernel_ids=(("lin_y_sens", 2), ("erk4_sens", 5)),
    )
