"""Body-rate quadrotor model (``rates``) with a body-frame velocity state.

nx=10 (p, q, v_body), nu=4 = (gamma, wx, wy, wz), each normalized and scaled
by ``cfg.robot.limits``; dp = R v, dv = R^T (-g e3) + gamma e3.  Stage
residual y = (p, eta[:2], q_e[3], R v, w) (ny=12); terminal yN drops w
(nyN=9).  Its linearization runs kernel 9 (``csrc/erk4_sens.cu``, device
function ``f_rates``); the stage residual's Jacobians come from
``torch.func``.
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
    scale = (float(lim.gamma), float(lim.wx), float(lim.wy), float(lim.wz))

    def _split(x):
        q = x[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return x[..., :3], q, x[..., 7:]

    def _w(u):
        return scale_inputs(u, scale)[..., 1:]

    def f(x, u):
        _, q, v = _split(x)
        gamma = scale_inputs(u, scale)[..., 0]
        R = m.quat2rot(q)
        zero = torch.zeros_like(gamma)
        dq = m.hamilton_prod(q, torch.cat([zero[..., None], _w(u)], -1)) / 2
        g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=x.dtype, device=x.device)
        dv = (R.transpose(-1, -2) @ g[:, None])[..., 0] + torch.stack([zero, zero, gamma], -1)
        return torch.cat([(R @ v[..., None])[..., 0], dq, dv], -1)

    def f_lanes(x, u):
        """``f`` in components."""
        q, R = lanes_quat(x[..., 3:7])
        v = [x[..., 7], x[..., 8], x[..., 9]]
        gamma = u[..., 0] * lim.gamma
        w = [u[..., 1] * lim.wx, u[..., 2] * lim.wy, u[..., 3] * lim.wz]
        dv = [-GRAVITY * R[2][0], -GRAVITY * R[2][1], -GRAVITY * R[2][2] + gamma]
        return torch.stack(lanes_mv3(R, v) + lanes_quat_deriv(q, w) + dv, -1)

    def _attitude_rows(x, p):
        pos, q, v = _split(x)
        q_e = m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))
        vw = (m.quat2rot(q) @ v[..., None])[..., 0]
        return [pos, m.quat2euler(q)[..., :2], q_e[..., 3:4], vw]

    def y(x, u, p):
        return torch.cat(_attitude_rows(x, p) + [_w(u)], -1)

    def yN(x, p):
        return torch.cat(_attitude_rows(x, p), -1)

    def u_to_cmd(x, u, p):
        return torch.cat([(mass * u[..., 0] * lim.gamma)[..., None], _w(u)], -1)

    def formate_ref(ref, n_extra: int = 0):
        yr = np.concatenate([ref.p, [0.0, 0.0, 0.0], ref.v, [0.0, 0.0, ref.wz], np.zeros(n_extra)])
        W = np.concatenate([ref.Wp, ref.Wq, ref.Wv, ref.Ww, np.zeros(n_extra)])
        return yr, W

    def vel_world(x):
        q = x[..., 3:7] / torch.linalg.vector_norm(x[..., 3:7], dim=-1, keepdim=True)
        return (m.quat2rot(q) @ x[..., 7:10, None])[..., 0]

    return ModelSpec(
        name="quad_rates",
        nx=10,
        nu=4,
        ny=12,
        nyN=9,
        f=f,
        y=y,
        yN=yN,
        u_hover=np.array([GRAVITY / lim.gamma, 0.0, 0.0, 0.0]),
        lbu=np.array([0.0, -1.0, -1.0, -1.0]),
        ubu=np.array([1.0, 1.0, 1.0, 1.0]),
        formate_ref=formate_ref,
        f_lanes=f_lanes,
        u_to_cmd=u_to_cmd,
        vel_world=vel_world,  # the state's v is body-frame
        kernel_consts=kernel_consts(scale),
        kernel_ids=(("erk4_sens", 0),),
    )
