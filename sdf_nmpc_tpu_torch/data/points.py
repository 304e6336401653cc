"""Range / depth images to points: the per-pixel ray grid, the min-pool,
the back-projection.

Counterpart of sdf_nmpc_tpu/data/points.py; ``pixel_grid`` and
``unit_rays`` are numpy.  Cartesian rays (1, tan(hfov)(1 - u/hw), tan(vfov)(1
- v/hh)); spherical rays interpolate azimuth and elevation linearly.  The
grid is float32, as the JAX package's, so an f64 computation that starts
from it keeps the same f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch


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


def unit_rays(height, width, hfov, vfov, is_spherical=False) -> np.ndarray:
    """(3, H*W) float32 unit pixel rays.  Each norm is summed as two fused
    multiply-adds, fma(z, z, fma(y, y, x*x)), each rounded once to float32
    (products exact in float64), which is how the JAX package's f32 norm
    runs on the CPU where the config-3 oracle was made: any other order
    moves a ray by an f32 ulp and the oracle's image by 1e-7."""
    rays = pixel_grid(height, width, hfov, vfov, is_spherical).reshape(3, -1)
    x, y, z = rays.astype(np.float64)
    f32 = lambda a: a.astype(np.float32).astype(np.float64)
    sq = f32(z * z + f32(y * y + f32(x * x)))
    return rays / np.sqrt(sq.astype(np.float32))


def minpool(imgs, k: int):
    """Non-overlapping spatial min-pool on (..., H, W), H and W divisible by k."""
    if k == 1:
        return imgs
    *lead, H, W = imgs.shape
    return imgs.reshape(*lead, H // k, k, W // k, k).amin(dim=(-3, -1))


def _points(imgs, dmax, hfov, vfov, is_depth, is_spherical, downsamp):
    """(B, N, 3) back-projected pixels of (B, H, W) images (pooled first)."""
    imgs = minpool(imgs, downsamp)
    H, W = imgs.shape[-2:]
    rays = (unit_rays(H, W, hfov, vfov, is_spherical).reshape(3, H, W)
            if not is_spherical and not is_depth else pixel_grid(H, W, hfov, vfov, is_spherical))
    rays = torch.as_tensor(rays, device=imgs.device).to(imgs.dtype)
    pts = (rays[None] * imgs[:, None] * dmax).reshape(imgs.shape[0], 3, -1)
    return pts.transpose(1, 2)


def _ranges(pts, is_depth):
    return pts[..., 0] if is_depth else torch.linalg.vector_norm(pts, dim=-1)


def imgs2points(imgs, dmax: float, hfov: float, vfov: float, is_depth: bool,
                is_spherical: bool, downsamp: int = 1, remove_d0: bool = False,
                remove_dmax: bool = False):
    """(H, W) or (B, H, W) dmax-normalized image -> (N, 3) / (B, N, 3) points.

    With ``remove_*`` set, the invalid points are dropped (d <= 0.01, d >=
    0.99 dmax): the result is then (M, 3), every image's points together."""
    single = imgs.dim() == 2
    if single:
        imgs = imgs[None]
    pts = _points(imgs, dmax, hfov, vfov, is_depth, is_spherical, downsamp)
    if remove_d0 or remove_dmax:
        d = _ranges(pts, is_depth)
        keep = torch.ones_like(d, dtype=torch.bool)
        if remove_d0:
            keep &= d > 0.01
        if remove_dmax:
            keep &= d < dmax * 0.99
        return pts[keep]
    return pts[0] if single else pts


def imgs2points_masked(imgs, dmax: float, hfov: float, vfov: float, is_depth: bool,
                       is_spherical: bool, downsamp: int = 1):
    """Static-shape variant: (points, valid mask), valid for 0.01 < d < 0.99 dmax."""
    single = imgs.dim() == 2
    if single:
        imgs = imgs[None]
    pts = _points(imgs, dmax, hfov, vfov, is_depth, is_spherical, downsamp)
    d = _ranges(pts, is_depth)
    mask = (d > 0.01) & (d < dmax * 0.99)
    return (pts[0], mask[0]) if single else (pts, mask)
