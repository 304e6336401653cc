"""Per-rotor quadrotor model (``props``): motor speeds, full rigid body.

nx=13 (p, q, v_world, w), nu=4 normalized motor speeds (wp = u * limits.wp).
The allocation matrices Gf, Gt come from ``cfg.robot.alloc`` by the GTMRP
construction (``_allocation_from_cfg``; the motors' alpha / beta angles are
read as radians, as the JAX package reads them); W_a = R Gf wp^2 / m - g e3,
dw = J^-1 (Gt wp^2 - w x J w).  y = (p, eta[:2], q_e[3], v, w, wp) (ny=16),
yN drops wp (nyN=12).  The normalized hover speed sqrt(m g / (4 cf)) / wp is
the warm start.  Its linearization runs kernel 9 (``csrc/erk4_sens.cu``,
device function ``f_props``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import math as m
from ..params import ParamLayout
from ..utils.device_consts import kept
from .base import GRAVITY, ModelSpec, kernel_consts, lanes_mv3, lanes_quat, lanes_quat_deriv


def _allocation_from_cfg(cfg):
    """(Gf, Gt), each (3, n motors), from cfg.robot.alloc."""
    motors = [list(mt) for mt in cfg.robot.alloc.motors]
    px, py, pz, alpha, beta, sign = (list(col) for col in zip(*motors))
    n = len(sign)
    cf = [float(cfg.robot.alloc.cf)] * n
    ct = [float(cfg.robot.alloc.ct)] * n
    R = [m.axis_rot("z", i * (np.pi / (n / 2))) @ m.axis_rot("y", beta[i])
         @ m.axis_rot("x", (-1) ** i * alpha[i]) for i in range(n)]
    Gf, Gt = m.gtmrp_matrix(R, np.array([px, py, pz]).T, sign, cf, ct)
    return np.asarray(cf) * Gf, np.asarray(cf) * Gt


def make_model(cfg) -> ModelSpec:
    lim = cfg.robot.limits
    layout = ParamLayout.from_cfg(cfg)
    mass = float(cfg.robot.mass)
    J = np.diag(np.asarray(cfg.robot.inertia, dtype=float))
    Jinv = np.linalg.inv(J)
    Gf, Gt = _allocation_from_cfg(cfg)
    wh = float(np.sqrt(mass * GRAVITY / 4 / cfg.robot.alloc.cf))

    def _split(x):
        q = x[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return x[..., :3], q, x[..., 7:10], x[..., 10:]

    def _world_acc(q, u):
        """(W_R_B, W_a)."""
        wp2 = (u * lim.wp) ** 2
        W_R_B = m.quat2rot(q)
        f_body = (kept(Gf, u) @ wp2[..., None])[..., 0]
        g = kept([0.0, 0.0, -GRAVITY], u)
        return W_R_B, (W_R_B @ f_body[..., None])[..., 0] / mass + g

    def f(x, u):
        _, q, v, w = _split(x)
        _, W_a = _world_acc(q, u)
        zero = torch.zeros_like(w[..., :1])
        dq = m.hamilton_prod(q, torch.cat([zero, w], -1)) / 2
        Jw = (kept(J, x) @ w[..., None])[..., 0]
        torque = (kept(Gt, u) @ ((u * lim.wp) ** 2)[..., None])[..., 0]
        dw = (kept(Jinv, x) @ (torque - torch.linalg.cross(w, Jw))[..., None])[..., 0]
        return torch.cat([v, dq, W_a, dw], -1)

    def f_lanes(x, u):
        """``f`` in components; the constant allocation and inertia matrices
        unroll into scalar coefficients."""
        q, R = lanes_quat(x[..., 3:7])
        v = [x[..., 7], x[..., 8], x[..., 9]]
        w = [x[..., 10], x[..., 11], x[..., 12]]
        t = [(u[..., i] * lim.wp) ** 2 for i in range(4)]
        gf = [sum(float(Gf[i, j]) * t[j] for j in range(4)) for i in range(3)]
        gt = [sum(float(Gt[i, j]) * t[j] for j in range(4)) for i in range(3)]
        W_a = lanes_mv3(R, gf)
        W_a = [W_a[0] / mass, W_a[1] / mass, W_a[2] / mass - GRAVITY]
        Jw = [float(J[i, i]) * w[i] for i in range(3)]
        cr = [w[1] * Jw[2] - w[2] * Jw[1], w[2] * Jw[0] - w[0] * Jw[2],
              w[0] * Jw[1] - w[1] * Jw[0]]
        dw = [float(Jinv[i, i]) * (gt[i] - cr[i]) for i in range(3)]
        return torch.stack(v + lanes_quat_deriv(q, w) + W_a + dw, -1)

    def yN(x, p):
        pos, q, v, w = _split(x)
        q_e = m.hamilton_prod(layout.get_q_d(p), m.quat_invert(q))
        return torch.cat([pos, m.quat2euler(q)[..., :2], q_e[..., 3:4], v, w], -1)

    def y(x, u, p):
        return torch.cat([yN(x, p), u * lim.wp], -1)

    def u_to_props(x, u, p):
        return u * lim.wp

    def u_to_acc(x, u, p):
        _, q, _, w = _split(x)
        W_R_B, W_a = _world_acc(q, u)
        return torch.cat([(W_R_B.transpose(-1, -2) @ W_a[..., None])[..., 0], w[..., 2:3]], -1)

    def formate_ref(ref, n_extra: int = 0):
        yr = np.concatenate(
            [ref.p, [0.0, 0.0, 0.0], ref.v, [0.0, 0.0, ref.wz], [wh] * 4, np.zeros(n_extra)])
        W = np.concatenate([ref.Wp, ref.Wq, ref.Wv, ref.Ww, [ref.Wa] * 4, np.zeros(n_extra)])
        return yr, W

    return ModelSpec(
        name="quad_props",
        nx=13,
        nu=4,
        ny=16,
        nyN=12,
        f=f,
        y=y,
        yN=yN,
        # the normalized hover speed (the reference stores the raw speed wh
        # against the normalized [0, 1] box; the JAX package fixes it so)
        u_hover=np.full(4, wh / lim.wp),
        lbu=np.zeros(4),
        ubu=np.ones(4),
        formate_ref=formate_ref,
        f_lanes=f_lanes,
        vel_world=lambda x: x[..., 7:10],
        u_to_acc=u_to_acc,
        u_to_props=u_to_props,
        kernel_consts=kernel_consts([lim.wp] * 4, mass, Gf, Gt, np.diag(J), np.diag(Jinv)),
        kernel_ids=(("erk4_sens", 2),),
    )
