"""Model abstraction: a dynamics model is a bundle of tensor functions plus
static dims.

Every callable takes tensors whose LAST axis holds the components and
broadcasts over leading batch axes:
  f(x, u)        -> xdot            continuous dynamics
  y(x, u, p)     -> (..., ny)       stage NLS residual outputs
  yN(x, p)       -> (..., nyN)      terminal NLS residual outputs
  u_to_*(x,u,p)  -> command vector  command maps
``f_lanes``/``y_lanes`` spell the same functions component by component;
they are the arithmetic the CUDA linearization kernels run as device
functions (``csrc/lin_y_sens.cu`` for the models with ``y_lanes``,
``csrc/erk4_sens.cu`` for the others), reading the constants of
``kernel_consts``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

GRAVITY = 9.81
# floats in the kernels' ModelConsts block (csrc/dual.cuh)
N_KERNEL_CONSTS = 35


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Immutable dynamics-model description."""

    name: str
    nx: int
    nu: int
    ny: int
    nyN: int
    f: Callable
    y: Callable
    yN: Callable
    u_hover: np.ndarray
    lbu: np.ndarray
    ubu: np.ndarray
    formate_ref: Callable  # formate_ref(ref, n_extra) -> (yr, W) numpy
    u_to_acc: Optional[Callable] = None  # (x, u, p) -> body acceleration + yaw rate
    u_to_TRPYr: Optional[Callable] = None  # (x, u, p) -> thrust, roll, pitch, yaw rate
    u_to_props: Optional[Callable] = None  # (x, u, p) -> propeller speeds
    u_to_cmd: Optional[Callable] = None  # (x, u, p) -> the model's native command
    f_lanes: Optional[Callable] = None
    y_lanes: Optional[Callable] = None  # y_lanes(x, u, q_d) -> (..., ny)
    # world-frame velocity x -> (..., 3): the hook of the recursive-feasibility
    # terminal rows; None where the model exposes none
    vel_world: Optional[Callable] = None
    # the constants the kernels' device functions read (kernel_consts below)
    kernel_consts: Optional[tuple] = None
    # ((kernel, id), ...): the model's instance in each linearization kernel
    # it has one in, the id of that source's switch ("lin_y_sens": kernel 1,
    # csrc/lin_y_sens.cu; "erk4_sens": kernel 9, csrc/erk4_sens.cu)
    kernel_ids: tuple = ()


def kernel_consts(scale, mass=0.0, Gf=None, Gt=None, J=None, Jinv=None) -> tuple:
    """The ModelConsts block of ``csrc/dual.cuh``, as N_KERNEL_CONSTS floats:
    the four input scales, the mass, Gf and Gt (3 x 4, row-major), and the
    diagonals of J and J^-1 (zeros where a model has none).  Each is the
    f64 value rounded to f32, as a JAX trace bakes a Python float."""
    z = lambda a, n: np.zeros(n) if a is None else np.asarray(a, np.float64).reshape(-1)
    block = np.concatenate([z(scale, 4), [mass], z(Gf, 12), z(Gt, 12), z(J, 3), z(Jinv, 3)])
    assert block.shape == (N_KERNEL_CONSTS,)
    return tuple(float(v) for v in block.astype(np.float32))


def scale_inputs(u, scale):
    """u (..., nu) times the per-input scales, as one vector product.  The
    differentiated model functions never scale a component alone: a Python
    float times a 0-dim tensor gets a float64 tangent under torch.func's
    forward mode."""
    return u * torch.as_tensor(scale, dtype=u.dtype, device=u.device)


def terminal_gate_enabled(cfg) -> bool:
    """Whether the terminal residual is gated by the sdf flag parameter:
    iff enable_sdf AND recursive_feasibility AND stability."""
    fl = cfg.flags
    return bool(fl.enable_sdf and fl.recursive_feasibility and fl.stability)


# ---- component forms: quaternion / rotation algebra on (..., k) tensors,
# returned as lists of (...,) components (the JAX package's lanes helpers,
# with the component axis last instead of first) ----


def lanes_quat(qraw):
    """Normalized components (q0..q3) and rotation entries R[i][j] of
    (..., 4) quaternions."""
    inv = torch.rsqrt(torch.clamp((qraw * qraw).sum(-1), min=1e-30))
    q0, q1, q2, q3 = (qraw[..., i] * inv for i in range(4))
    R = [
        [q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3, 2 * (q1 * q2 - q0 * q3), 2 * (q1 * q3 + q0 * q2)],
        [2 * (q1 * q2 + q0 * q3), q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3, 2 * (q2 * q3 - q0 * q1)],
        [2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1), q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3],
    ]
    return (q0, q1, q2, q3), R


def lanes_mv3(R, v):
    """R @ v for a component-list rotation R and a 3-list v."""
    return [R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2] for i in range(3)]


def lanes_mv3t(R, v):
    """R^T @ v."""
    return [R[0][i] * v[0] + R[1][i] * v[1] + R[2][i] * v[2] for i in range(3)]


def lanes_quat_deriv(q, w):
    """hamilton(q, (0, w)) / 2 in components."""
    q0, q1, q2, q3 = q
    return [
        0.5 * (-q1 * w[0] - q2 * w[1] - q3 * w[2]),
        0.5 * (q0 * w[0] + q2 * w[2] - q3 * w[1]),
        0.5 * (q0 * w[1] - q1 * w[2] + q3 * w[0]),
        0.5 * (q0 * w[2] + q1 * w[1] - q2 * w[0]),
    ]
