"""Model abstraction: a dynamics model is a bundle of tensor functions plus
static dims.

Every callable takes tensors whose LAST axis holds the components and
broadcasts over leading batch axes:
  f(x, u)        -> xdot            continuous dynamics
  y(x, u, p)     -> (..., ny)       stage NLS residual outputs
  yN(x, p)       -> (..., nyN)      terminal NLS residual outputs
``f_lanes``/``y_lanes`` spell the same functions component by component; they
are the arithmetic the CUDA linearization kernel runs (``csrc/lin_y_sens.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

GRAVITY = 9.81


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
    f_lanes: Optional[Callable] = None
    y_lanes: Optional[Callable] = None
    # limits the CUDA kernel's device functions read: (gamma, roll, pitch, wz)
    kernel_limits: Optional[tuple] = None


def terminal_gate_enabled(cfg) -> bool:
    """Whether the terminal residual is gated by the sdf flag parameter:
    iff enable_sdf AND recursive_feasibility AND stability."""
    fl = cfg.flags
    return bool(fl.enable_sdf and fl.recursive_feasibility and fl.stability)
