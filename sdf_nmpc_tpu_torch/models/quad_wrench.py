"""Wrench quadrotor model (``wrench``): thrust and inertia-normalized torques.

nx=13 (p, q, v_body, w), nu=4 = (gamma, normalized torques); the
translational dynamics are those of ``rates`` (body-frame velocity), the
rotational ones dw = torques.  The reference model's gyroscopic term
``cross(w, w)`` is identically zero, and the JAX package keeps it so: so
does this port.  y = (p, eta[:2], q_e[3], R v, w), ny=nyN=12.  Its
linearization runs kernel 9 (``csrc/erk4_sens.cu``, device function
``f_wrench``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as m
from ..params import ParamLayout
from .base import (GRAVITY, ModelSpec, kernel_consts, lanes_mv3, lanes_quat,
                   lanes_quat_deriv, scale_inputs)


def make_model(cfg) -> ModelSpec:
    lim = cfg.robot.limits
    layout = ParamLayout.from_cfg(cfg)
    mass = float(cfg.robot.mass)
    inertia = np.diag(np.asarray(cfg.robot.inertia, dtype=float))
    scale = (float(lim.gamma), float(lim.torques), float(lim.torques), float(lim.torques))

    def _split(x):
        q = x[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return x[..., :3], q, x[..., 7:10], x[..., 10:]

    def f(x, u):
        _, q, v, w = _split(x)
        us = scale_inputs(u, scale)
        gamma, torques = us[..., 0], us[..., 1:]
        R = m.quat2rot(q)
        zero = torch.zeros_like(gamma)
        dq = m.hamilton_prod(q, torch.cat([zero[..., None], w], -1)) / 2
        g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=x.dtype, device=x.device)
        dv = (R.transpose(-1, -2) @ g[:, None])[..., 0] + torch.stack([zero, zero, gamma], -1)
        return torch.cat([(R @ v[..., None])[..., 0], dq, dv, torques], -1)

    def f_lanes(x, u):
        """``f`` in components."""
        q, R = lanes_quat(x[..., 3:7])
        v = [x[..., 7], x[..., 8], x[..., 9]]
        w = [x[..., 10], x[..., 11], x[..., 12]]
        gamma = u[..., 0] * lim.gamma
        dv = [-GRAVITY * R[2][0], -GRAVITY * R[2][1], -GRAVITY * R[2][2] + gamma]
        dw = [u[..., 1] * lim.torques, u[..., 2] * lim.torques, u[..., 3] * lim.torques]
        return torch.stack(lanes_mv3(R, v) + lanes_quat_deriv(q, w) + dv + dw, -1)

    def yN(x, p):
        pos, q, v, w = _split(x)
        q_e = m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))
        vw = (m.quat2rot(q) @ v[..., None])[..., 0]
        return torch.cat([pos, m.quat2euler(q)[..., :2], q_e[..., 3:4], vw, w], -1)

    def y(x, u, p):
        return yN(x, p)

    def u_to_cmd(x, u, p):
        torques = scale_inputs(u, scale)[..., 1:]
        J = torch.as_tensor(inertia, dtype=u.dtype, device=u.device)
        return torch.cat([(mass * u[..., 0] * lim.gamma)[..., None],
                          (J @ torques[..., None])[..., 0]], -1)

    def formate_ref(ref, n_extra: int = 0):
        yr = np.concatenate([ref.p, [0.0, 0.0, 0.0], ref.v, [0.0, 0.0, ref.wz], np.zeros(n_extra)])
        W = np.concatenate([ref.Wp, ref.Wq, ref.Wv, ref.Ww, np.zeros(n_extra)])
        return yr, W

    def vel_world(x):
        q = x[..., 3:7] / torch.linalg.vector_norm(x[..., 3:7], dim=-1, keepdim=True)
        return (m.quat2rot(q) @ x[..., 7:10, None])[..., 0]

    return ModelSpec(
        name="quad_wrench",
        nx=13,
        nu=4,
        ny=12,
        nyN=12,
        f=f,
        y=y,
        yN=yN,
        # the normalized hover thrust (the reference stores the raw g against
        # the normalized [0, 1] box; the JAX package fixes it so)
        u_hover=np.array([GRAVITY / lim.gamma, 0.0, 0.0, 0.0]),
        lbu=np.array([0.0, -1.0, -1.0, -1.0]),
        ubu=np.array([1.0, 1.0, 1.0, 1.0]),
        formate_ref=formate_ref,
        f_lanes=f_lanes,
        u_to_cmd=u_to_cmd,
        vel_world=vel_world,  # the state's v is body-frame
        kernel_consts=kernel_consts(scale),
        kernel_ids=(("erk4_sens", 1),),
    )
