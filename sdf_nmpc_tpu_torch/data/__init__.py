"""Data helpers: the sensor's per-pixel ray grid."""

from .points import pixel_grid

__all__ = ["pixel_grid"]
