"""The stability terminal-cost constant r-tilde.

Counterpart of sdf_nmpc_tpu/theory/stability.py.  The closed form of the
reference's symbolic root:

    r_tilde(T, phi, theta) = (U' R U) / (dt^2 |T R(phi, theta) e3 - g e3|^2)

with U = [T - g, phi, theta] and R = diag(acc_w, att_w0, att_w1), maximized
over the thrust / attitude box deterministically: the best point of a dense
grid, then projected gradient ascent by ``torch.autograd``, all in f64.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..models.base import GRAVITY


def r_tilde_value(T, phi, theta, *, g, dt, r1, r2, r3):
    """Closed-form r_tilde on tensors T, phi, theta of one shape."""
    # body z-axis in the world frame for (roll phi, pitch theta, yaw 0)
    Re3 = torch.stack([torch.sin(theta) * torch.cos(phi), -torch.sin(phi),
                       torch.cos(theta) * torch.cos(phi)], -1)
    U_tilde = T[..., None] * Re3 - torch.tensor([0.0, 0.0, g], dtype=T.dtype, device=T.device)
    denom = dt**2 * (U_tilde**2).sum(-1)
    num = r1 * (T - g) ** 2 + r2 * phi**2 + r3 * theta**2
    return num / torch.clamp(denom, min=1e-12)


def get_r_tilde_max(cfg, grid_n: int = 96, polish_iters: int = 200, lr: float = 1e-3,
                    device="cuda") -> float:
    """Maximum of r_tilde over the thrust / attitude box: the grid's best
    point, then ``polish_iters`` steps of projected gradient ascent."""
    dev = resolve_device(device)
    dt = cfg.mpc.T / cfg.mpc.N
    wts = cfg.mpc.weights.set_const_off
    kw = dict(g=GRAVITY, dt=dt, r1=float(wts.acc), r2=float(wts.att[0]), r3=float(wts.att[1]))
    lim = cfg.robot.limits
    T_hi, phi_m, theta_m = float(lim.gamma), float(lim.roll), float(lim.pitch)

    f64 = dict(dtype=torch.float64, device=dev)
    axes = (torch.linspace(0.0, T_hi, grid_n, **f64), torch.linspace(-phi_m, phi_m, grid_n, **f64),
            torch.linspace(-theta_m, theta_m, grid_n, **f64))
    Tg, Pg, Hg = (a.reshape(-1) for a in torch.meshgrid(*axes, indexing="ij"))
    best = int(torch.argmax(r_tilde_value(Tg, Pg, Hg, **kw)))
    x = torch.stack([Tg[best], Pg[best], Hg[best]])
    lo = torch.tensor([0.0, -phi_m, -theta_m], **f64)
    hi = torch.tensor([T_hi, phi_m, theta_m], **f64)
    for _ in range(polish_iters):
        x = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(-r_tilde_value(x[0], x[1], x[2], **kw), x)
        x = torch.clamp(x.detach() - lr * grad, lo, hi)
    return float(r_tilde_value(x[0], x[1], x[2], **kw))
