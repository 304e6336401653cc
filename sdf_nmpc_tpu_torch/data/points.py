"""Per-pixel ray directions of a range or depth image.

Own copy of sdf_nmpc_tpu/data/points.py ``pixel_grid`` (:16-28), numpy
only.  Cartesian rays (1, tan(hfov)(1 - u/hw), tan(vfov)(1 - v/hh));
spherical rays interpolate azimuth and elevation linearly.  The grid is
float32, as the JAX package's, so an f64 render that starts from it keeps
the same f32 rounding.
"""

from __future__ import annotations

import numpy as np


def pixel_grid(height: int, width: int, hfov: float, vfov: float,
               is_spherical: bool) -> np.ndarray:
    """(3, H, W) float32 per-pixel ray directions."""
    u, v = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32), indexing="xy"
    )
    hw, hh = width / 2, height / 2
    if is_spherical:
        az = hfov * (1 - u / hw)
        el = vfov * (1 - v / hh)
        p = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    else:
        p = np.stack([np.ones_like(u), np.tan(hfov) * (1 - u / hw), np.tan(vfov) * (1 - v / hh)])
    return p.astype(np.float32)
