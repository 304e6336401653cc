"""Ground-truth collision labels from depth / range images.

Counterpart of sdf_nmpc_tpu/data/collision.py (the reference's Warp kernel
``_kernel_colcheck``), PyTorch ops over every point at once:

  * points inside the safe ball are free;
  * the value of interest is the depth p_x (depth mode) or |p| (range mode);
  * val >= dmax is a collision (beyond the horizon is unsafe);
  * outside the field of view: 'free' (label 0), 'col' (label 1) or
    'extrapolate' (the angles clamped onto the image border);
  * otherwise the point is projected to its pixel (tan-interpolated for a
    Cartesian sensor, linear for a spherical one) and collides iff
    val >= img[v, u] * dmax.

Points take any leading shape (..., 3), with the image index of each point
broadcastable to it, so a point x offset grid is checked without repeating
the index.  ``label_margins`` gives each decision's distance to its
boundary, to tell an f32 rounding flip from a fault.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

OUTSIDE = {"free": 0, "col": 1, "extrapolate": 2}


def as_inputs(imgs, points, p_to_i, device, dtype):
    """(imgs (B, H, W), points (N, 3), p_to_i (N,)) on ``device`` in
    ``dtype``: one (H, W) image taken as a batch of one; ``p_to_i`` as a
    long tensor, or by default the points split evenly over the images in
    order."""
    imgs = torch.as_tensor(imgs, device=device).to(dtype)
    if imgs.dim() == 2:
        imgs = imgs[None]
    points = torch.as_tensor(points, device=device).to(dtype)
    if p_to_i is None:
        per_img = points.shape[0] // imgs.shape[0]
        p_to_i = torch.arange(imgs.shape[0], device=device).repeat_interleave(per_img)
    return imgs, points, torch.as_tensor(p_to_i, device=device).long()


class ColChecker:
    """Parallel collision checker (the reference's ColChecker API)."""

    def __init__(self, dmax, hfov, vfov, safe_ball_size, is_depth=False, is_spherical=False,
                 outside="free", device="cuda", dtype=torch.float32):
        if outside not in OUTSIDE:
            raise ValueError(f"outside must be one of {sorted(OUTSIDE)}, not {outside!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.geometry = dict(dmax=float(dmax), hfov=float(hfov), vfov=float(vfov),
                             safe_ball=float(safe_ball_size), is_depth=bool(is_depth),
                             is_spherical=bool(is_spherical), outside=OUTSIDE[outside])

    def check_image_points(self, imgs, points, p_to_i=None):
        """imgs: (B, H, W) or (H, W) dmax-normalized; points: (N, 3) metres.
        (N,) bool labels, True = collision."""
        return check_image_points_impl(*as_inputs(imgs, points, p_to_i, self.device,
                                                  self.dtype), **self.geometry)

    def label_margins(self, imgs, points, p_to_i=None):
        return label_margins(*as_inputs(imgs, points, p_to_i, self.device, self.dtype),
                             **self.geometry)


def _project(points, H, W, *, dmax, hfov, vfov, is_depth, is_spherical, outside):
    """(norm, val, in_fov, u, v, azimuth, elevation): u, v the pixel
    coordinates before the truncation to an index."""
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    norm = torch.linalg.vector_norm(points, dim=-1)
    val = px if is_depth else norm
    azimuth = torch.atan2(py, px)
    if is_spherical:
        elevation = torch.atan2(pz, torch.sqrt(px**2 + py**2))
    else:
        elevation = torch.atan2(pz, px)
    in_fov = (azimuth.abs() < hfov) & (elevation.abs() < vfov)
    if outside == 2:  # extrapolate: clamp onto the image border
        azimuth = azimuth.clamp(-hfov, hfov)
        elevation = elevation.clamp(-vfov, vfov)
    if is_spherical:
        u = W / 2.0 * (1.0 - azimuth / hfov)
        v = H / 2.0 * (1.0 - elevation / vfov)
    else:
        u = W / 2.0 * (1.0 - torch.tan(azimuth) / np.tan(hfov))
        v = H / 2.0 * (1.0 - torch.tan(elevation) / np.tan(vfov))
    return norm, val, in_fov, u, v, azimuth, elevation


def _index(c, size):
    """int32 truncation toward zero, then clipped to [0, size - 1] (the
    float clamped first so that the conversion cannot overflow)."""
    return c.clamp(-1.0, float(size)).to(torch.int32).clamp(0, size - 1).long()


def check_image_points_impl(imgs, points, p_to_i, *, dmax, hfov, vfov, safe_ball, is_depth,
                            is_spherical, outside):
    """Labels of points (..., 3) against imgs (B, H, W); p_to_i broadcasts
    to the points' leading shape (sdf_nmpc_tpu/data/collision.py:63-102)."""
    H, W = imgs.shape[1], imgs.shape[2]
    norm, val, in_fov, u, v, _, _ = _project(
        points, H, W, dmax=dmax, hfov=hfov, vfov=vfov, is_depth=is_depth,
        is_spherical=is_spherical, outside=outside)
    pixel_val = imgs[p_to_i, _index(v, H), _index(u, W)]
    col_by_pixel = val >= pixel_val * dmax
    col_beyond = val >= dmax
    if outside == 0:  # outside the field of view is free
        col = col_beyond | (in_fov & col_by_pixel)
    elif outside == 1:  # outside the field of view is a collision
        col = col_beyond | ~in_fov | col_by_pixel
    else:  # extrapolate
        col = col_beyond | col_by_pixel
    return col & (norm > safe_ball)


def label_margins(imgs, points, p_to_i, *, dmax, hfov, vfov, safe_ball, is_depth,
                  is_spherical, outside):
    """Each decision of ``check_image_points_impl`` as its distance to the
    boundary where it flips, per point: 'metres' the least of |val - pixel
    dmax|, |val - dmax| and |norm - safe_ball|; 'pixels' the least distance
    of u or v to an integer k in [1, size - 1] (where the clipped index
    moves); 'radians' the least of ||azimuth| - hfov| and ||elevation| -
    vfov| (inf under 'extrapolate', which does not read the field of
    view)."""
    H, W = imgs.shape[1], imgs.shape[2]
    norm, val, _, u, v, az, el = _project(
        points, H, W, dmax=dmax, hfov=hfov, vfov=vfov, is_depth=is_depth,
        is_spherical=is_spherical, outside=outside)
    pixel_val = imgs[p_to_i, _index(v, H), _index(u, W)]
    metres = torch.minimum(torch.minimum((val - pixel_val * dmax).abs(), (val - dmax).abs()),
                           (norm - safe_ball).abs())
    pixels = torch.minimum((u - u.round().clamp(1, W - 1)).abs(),
                           (v - v.round().clamp(1, H - 1)).abs())
    radians = torch.minimum((az.abs() - hfov).abs(), (el.abs() - vfov).abs())
    if outside == 2:
        radians = torch.full_like(radians, torch.inf)
    return {"metres": metres, "pixels": pixels, "radians": radians}
