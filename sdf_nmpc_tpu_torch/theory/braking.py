"""Braking-distance analysis: the largest deceleration per velocity
direction, and polynomial / MLP surrogates of the braking distance.

Counterpart of sdf_nmpc_tpu/theory/braking.py.  For every direction at once,

    max |a|   s.t. a colinear with -v,  a = -g e3 + R(roll, pitch, 0) (0, 0, T)

in the thrust and attitude boxes, by a fixed-iteration bisection on the
deceleration (feasibility is monotone along each direction), in f64.  The
surrogate fits: ``fit_poly``, closed-form least squares on the 3-variate
monomial basis; ``fit_mlp``, Adam on a tanh ``nn.mlp.Mlp``.

Braking distance: bdist(v) = 0.5 |v|^2 / a_max(v_hat).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..math import polynomial_3variate_exponents
from ..models.base import GRAVITY


def max_braking_accel(v_dirs, cfg, iters: int = 60, device="cuda"):
    """a_max (N,) numpy for each velocity direction of v_dirs (N, 3).

    A deceleration s along -vhat needs the mass-normalized thrust vector
    f = g e3 - s vhat, feasible iff |f| <= gamma and its attitude (roll =
    asin(-f_y / |f|), pitch = atan2(f_x, f_z) at yaw 0) lies in the attitude
    box; free fall (|f| ~ 0) is feasible in any attitude."""
    dev = resolve_device(device)
    lim = cfg.robot.limits
    gamma_max = float(lim.gamma)
    roll_max, pitch_max = float(lim.roll), float(lim.pitch)
    v = torch.as_tensor(np.asarray(v_dirs, np.float64), device=dev)
    vhat = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    e3g = torch.tensor([0.0, 0.0, GRAVITY], dtype=torch.float64, device=dev)

    def feasible(s):
        f = e3g - s[:, None] * vhat
        T = torch.linalg.vector_norm(f, dim=-1)
        fhat = f / torch.clamp(T, min=1e-9)[:, None]
        roll = torch.asin(torch.clamp(-fhat[:, 1], -1.0, 1.0))
        pitch = torch.atan2(fhat[:, 0], fhat[:, 2])
        att_ok = (roll.abs() <= roll_max) & (pitch.abs() <= pitch_max)
        return (T <= gamma_max) & (att_ok | (T < 1e-6))

    lo = torch.zeros(vhat.shape[0], dtype=torch.float64, device=dev)
    hi = torch.full_like(lo, gamma_max + GRAVITY)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo.cpu().numpy()


def braking_grid(cfg, vmax: float = 3.0, step: float = 0.05, device="cuda"):
    """(vel, bdist, amax) over the ball grid 0 < |v| < vmax."""
    v = np.arange(-vmax, vmax + 0.01, step)
    vel = np.stack(np.meshgrid(v, v, v, indexing="ij"), axis=-1).reshape(-1, 3)
    vel = vel[np.linalg.norm(vel, axis=1) < vmax]
    vel = vel[np.linalg.norm(vel, axis=1) > 1e-9]
    vhat = vel / np.linalg.norm(vel, axis=1, keepdims=True)
    amax = max_braking_accel(vhat, cfg, device=device)
    norms = np.linalg.norm(vel, axis=1)
    bdist = np.where(amax > 1e-8, 0.5 * norms**2 / np.maximum(amax, 1e-8), 0.0)
    return vel, bdist, amax


def min_braking_accel(vel, bdist):
    """a_b_min over a grid result (cfg.mpc.stability.a_b_min)."""
    idx = bdist > 1e-8
    return float(np.min(np.linalg.norm(vel[idx], axis=1) ** 2 / 2 / bdist[idx]))


def fit_poly(vel, bdist, degree: int = 4):
    """Least-squares 3-variate polynomial coefficients (closed form)."""
    exps = polynomial_3variate_exponents(degree)
    design = np.prod(vel[:, None, :] ** exps[None], axis=-1)  # (N, n_terms)
    coeffs, *_ = np.linalg.lstsq(design, bdist, rcond=None)
    return coeffs


def eval_surrogate(poly_fn, vel, bdist):
    """(rmse, max_err) of a surrogate poly_fn (tensor (N, 3) -> (N,) or
    (N, 1)) on grid data."""
    with torch.no_grad():
        pred = poly_fn(torch.as_tensor(np.asarray(vel, np.float64))).double().cpu().numpy()
    err = pred.flatten() - bdist
    return float(np.sqrt(np.mean(err**2))), float(np.max(np.abs(err)))


def fit_mlp(vel, bdist, layer_sizes=(20, 20, 20), epochs: int = 200, batch_size: int = 256,
            lr: float = 1e-3, seed: int = 0, device="cuda"):
    """tanh-MLP surrogate trained with Adam in f32: (module, last batch
    loss).  The weights are drawn from a ``torch.Generator`` seeded with
    ``seed``; the batches follow the numpy permutations of the JAX version
    (``np.random.default_rng(seed)``, one per epoch)."""
    from ..nn.mlp import Mlp

    dev = resolve_device(device)
    module = Mlp(3, 1, layer_sizes, inner_act=torch.tanh,
                 generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    x = torch.as_tensor(np.asarray(vel), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.asarray(bdist), dtype=torch.float32, device=dev)[:, None]
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for i in range(0, n, batch_size):
            sl = order[i:i + batch_size]
            opt.zero_grad()
            loss = torch.mean((module(x[sl]) - y[sl]) ** 2)
            loss.backward()
            opt.step()
    module.eval()
    return module, float(loss.detach())
