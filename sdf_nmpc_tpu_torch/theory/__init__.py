"""Offline theory tooling: braking distance, stability constants."""

from .braking import (
    braking_grid,
    eval_surrogate,
    fit_mlp,
    fit_poly,
    max_braking_accel,
    min_braking_accel,
)
from .stability import get_r_tilde_max, r_tilde_value

__all__ = ["braking_grid", "eval_surrogate", "fit_mlp", "fit_poly", "get_r_tilde_max",
           "max_braking_accel", "min_braking_accel", "r_tilde_value"]
