"""Quaternion and rotation helpers on tensors.

Conventions match the JAX package: quaternions are scalar-first
[qw qx qy qz] (Hamilton), euler angles are [roll pitch yaw] (Z1Y2X3).  Every
function works on the last axis and broadcasts over leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch


def quat2rot(q):
    """Rotation matrix from quaternion: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ]
    return torch.stack(rows, dim=-2)


def euler2rot(euler):
    """Rotation matrix from [roll pitch yaw]: (..., 3) -> (..., 3, 3)."""
    r, p, y = euler.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy], -1)
    row1 = torch.stack([cp * sy, sr * sp * sy + cr * cy, cr * sp * sy - sr * cy], -1)
    row2 = torch.stack([-sp, sr * cp, cr * cp], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat2yaw(q):
    """Yaw angle from quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def yaw2quat(yaw):
    """Pure-yaw quaternion."""
    h = yaw * 0.5
    z = torch.zeros_like(h)
    return torch.stack([torch.cos(h), z, z, torch.sin(h)], -1)


def quat_invert(q):
    """Inverse (normalized conjugate) quaternion."""
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return q * sign / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def hamilton_prod(q1, q2):
    """Hamilton product q1*q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        -1,
    )


def quat2euler(q):
    """[roll pitch yaw] from quaternion: (..., 4) -> (..., 3).  Pitch is the
    asin of its argument clipped to [-1, 1]."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], -1)


def deuler_avel_map(euler):
    """Map from euler-angle rates to body angular rates: (..., 3) -> (..., 3, 3).

    Kept entry for entry as the JAX package has it, including its (0, 2) and
    (1, 2) entries, since quad_att_tau's dynamics are defined through it."""
    r, p = euler[..., 0], euler[..., 1]
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    sr, cr, sp, cp = torch.sin(r), torch.cos(r), torch.sin(p), torch.cos(p)
    row0 = torch.stack([one, sp * sr / cp, sp * cr], -1)
    row1 = torch.stack([zero, cr, -sp], -1)
    row2 = torch.stack([zero, sr / cp, cr / cp], -1)
    return torch.stack([row0, row1, row2], dim=-2)


# ---- GTMRP allocation (numpy: constant data of a model, built once) ----


def axis_rot(axis: str, angle: float) -> np.ndarray:
    """Rotation matrix about the x, y or z axis."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise ValueError(axis)


def gtmrp_matrix(R, p, signs, c_f, c_t):
    """Force and torque allocation matrices Gf, Gt (3, n) of rotors with
    orientations R, positions p, spin signs and force / torque coefficients."""
    Rz = [np.asarray(r) @ np.array([0.0, 0.0, 1.0]) for r in R]
    G_f = np.column_stack(Rz)
    G_t = np.column_stack([
        np.cross(np.asarray(p[i]).flatten(), Rz[i].flatten()) + c_t[i] / c_f[i] * signs[i] * Rz[i]
        for i in range(len(R))
    ])
    return G_f, G_t


# ---- 3-variate polynomial (the braking-distance surrogate) ----


def polynomial_3variate_exponents(deg: int) -> np.ndarray:
    """(n_terms, 3) monomial exponents of the 3-variate polynomial of degree
    ``deg``: total degree 0..deg, then a = 0..total, b = 0..total - a,
    c = total - a - b, term x0^a x1^b x2^c.  This order fixes the layout of
    the fitted coefficient files."""
    rows = [(a, b, total - a - b) for total in range(deg + 1) for a in range(total + 1)
            for b in range(total + 1 - a)]
    exps = np.array(rows, dtype=np.int64)
    assert len(exps) == (deg + 1) * (deg + 2) * (deg + 3) // 6
    return exps


def polynomial_3variate(deg: int, coeffs=None):
    """(poly_fn, exponents) of the 3-variate polynomial of degree ``deg``.
    With ``coeffs``, poly_fn(x) evaluates with them, else poly_fn(x, coeffs);
    x (..., 3) -> (...,).  The powers x^0..x^deg of each coordinate are built
    by products and gathered per term, so a negative base and its gradient
    stay exact (no float pow)."""
    exps = polynomial_3variate_exponents(deg)

    def _eval(x, c):
        powers = [torch.ones_like(x)]
        for _ in range(deg):
            powers.append(powers[-1] * x)
        table = torch.stack(powers, -2)  # (..., deg + 1, 3)
        idx = torch.as_tensor(exps, device=x.device)
        monomials = table[..., idx, torch.arange(3, device=x.device)].prod(-1)  # (..., n_terms)
        return monomials @ torch.as_tensor(c, dtype=x.dtype, device=x.device)

    if coeffs is None:
        return _eval, exps
    c = np.asarray(coeffs, np.float64)
    return (lambda x: _eval(x, c)), exps
