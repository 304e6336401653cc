"""Explicit RK4 with a per-interval step size, and its exact sensitivities."""

from __future__ import annotations

from torch.func import jacfwd


def erk4(f, x, u, dt):
    """Classic RK4 step of xdot = f(x, u); dt is a scalar or broadcasts
    against x's leading axes (pass dt[..., None] for a batch)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def erk4_with_sensitivities(f, x, u, dt):
    """(x_next, A, B) for one point: A = dx+/dx (nx, nx), B = dx+/du (nx, nu),
    by forward mode (nx + nu tangents of a cheap rollout).  Batch it with
    ``torch.func.vmap``."""
    step = lambda x_, u_: erk4(f, x_, u_, dt)
    A, B = jacfwd(step, argnums=(0, 1))(x, u)
    return step(x, u), A, B
