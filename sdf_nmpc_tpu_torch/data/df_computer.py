"""Ground-truth signed / unsigned distance fields from range images.

Counterpart of sdf_nmpc_tpu/data/df_computer.py (the reference's Warp
pipeline), PyTorch ops:

  * UDF: the distance from each query point to each (min-pooled) pixel's
    back-projected position, with a virtual wall at dmax; the row minimum is
    the UDF and its pixel gives the gradient direction.  The points go in
    chunks of ``batch_size``, so memory stays bounded (the JAX package
    builds the whole (N, H W / 25, 3) tensor at once);
  * SDF: the occupancy sign from the collision checker ('extrapolate'),
    then the multi-resolution spherical offset grid (K = 17,652 offsets)
    searched for the nearest voxel of the opposite occupancy, in chunks of
    ``batch_size`` points; results clamped to [-0.3, 1.0] with saturated
    gradients zeroed.

Ties go to the first index (``torch.argmin``, as ``jnp.argmin``).  The
JAX package's quirks are kept: ``max_df`` is fixed at 1.0 whatever the
constructor is given, and a wall-closest UDF entry carries the absolute
point (dmax, p_y, p_z) as its gradient direction.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .collision import ColChecker, as_inputs, check_image_points_impl
from .points import pixel_grid

GRID_PARAMS = [(0, 0.1, 0.01), (0.1, 0.2, 0.02), (0.2, 0.3, 0.03), (0.3, 0.5, 0.05), (0.5, 1, 0.1)]


def generate_dist_grid(grid_params=GRID_PARAMS):
    """(distances (K,), offsets (K, 3)), float32 numpy: the shells of the
    multi-resolution offset grid, the voxel step growing with the radius."""
    grids, dists = [], []
    for dmin, dmax, step in grid_params:
        n = int(2.0 * dmax / step) + 1
        coords = np.linspace(-dmax, dmax, n, dtype=np.float32)
        g = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), axis=-1).reshape(-1, 3)
        d = np.linalg.norm(g, axis=1)
        sel = (d > dmin) & (d <= dmax)
        grids.append(g[sel])
        dists.append(d[sel])
    return np.concatenate(dists), np.concatenate(grids)


def minpool_ignore_zeros(imgs, k: int, dmax_norm: float = 1.0):
    """k x k min-pool of (B, H, W) that ignores 0 pixels; an all-zero block
    stays 0."""
    B, H, W = imgs.shape
    x = imgs.reshape(B, H // k, k, W // k, k).permute(0, 1, 3, 2, 4).reshape(
        B, H // k, W // k, k * k)
    any_nonzero = (x != 0).any(-1)
    pooled = torch.where(x == 0, torch.full_like(x, dmax_norm), x).amin(-1)
    return torch.where(any_nonzero, pooled, torch.zeros_like(pooled))


class DfComputer:
    """Signed / unsigned distance-field computer (the reference's API)."""

    def __init__(self, signed, dmax, hfov, vfov, max_df, is_depth=False, is_spherical=False,
                 batch_size=5000, device="cuda", dtype=torch.float32):
        self.signed = bool(signed)
        self.dmax = float(dmax)
        self.hfov = float(hfov)
        self.vfov = float(vfov)
        self.min_df = -0.3
        self.max_df = 1.0
        self.is_depth = bool(is_depth)
        self.is_spherical = bool(is_spherical)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.dtype = dtype
        if self.signed:
            self.colcheck = ColChecker(dmax, hfov, vfov, 0, is_depth, is_spherical,
                                       "extrapolate", device=self.device, dtype=dtype)
            dists, grid = generate_dist_grid()
            self.distances = torch.as_tensor(dists, device=self.device).to(dtype)
            self.grid = torch.as_tensor(grid, device=self.device).to(dtype)

    def get_df(self, imgs, points, p_to_i=None):
        """(df (N,), grad (N, 3)) of points (N, 3) against imgs (B, H, W)."""
        imgs, points, p_to_i = as_inputs(imgs, points, p_to_i, self.device, self.dtype)
        if self.signed:
            return self.get_sdf(imgs, points, p_to_i)
        return self.get_udf(imgs, points, p_to_i)

    def get_udf(self, imgs, points, p_to_i, pool_kernel: int = 5):
        if imgs.shape[1] % pool_kernel or imgs.shape[2] % pool_kernel:
            raise ValueError(f"image size {tuple(imgs.shape[1:])} is not divisible by the "
                             f"pool kernel {pool_kernel}")
        pooled = minpool_ignore_zeros(imgs, pool_kernel)
        parts = [_udf_impl(pooled, points[i:i + self.batch_size], p_to_i[i:i + self.batch_size],
                           dmax=self.dmax, hfov=self.hfov, vfov=self.vfov,
                           is_depth=self.is_depth, is_spherical=self.is_spherical,
                           max_df=self.max_df)
                 for i in range(0, points.shape[0], self.batch_size)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def search(self, imgs, points, p_to_i):
        """The SDF's search: (occupied (N,), distance to the nearest voxel of
        the other occupancy (N,), its offset index (N,))."""
        occupied = self.colcheck.check_image_points(imgs, points, p_to_i)
        mins, args = [], []
        for i in range(0, points.shape[0], self.batch_size):
            sl = slice(i, i + self.batch_size)
            md, ai = _sdf_chunk(imgs, points[sl], p_to_i[sl], occupied[sl],
                                check=self.colcheck.geometry, grid=self.grid,
                                distances=self.distances, max_df=self.max_df)
            mins.append(md)
            args.append(ai)
        return occupied, torch.cat(mins), torch.cat(args)

    def get_sdf(self, imgs, points, p_to_i):
        occupied, mindist, argmin = self.search(imgs, points, p_to_i)
        return sdf_from_search(occupied, mindist, argmin, self.grid, self.min_df, self.max_df)


def sdf_from_search(occupied, mindist, argmin, grid, min_df, max_df):
    """(sdf, grad) of the search's results: signed, clamped to [min_df,
    max_df], the gradient the unit offset away from the nearest voxel, 0
    where the value saturates."""
    sign = 1 - 2 * occupied.to(mindist.dtype)  # +1 free, -1 occupied
    grad_dirs = grid[argmin]
    sdf = torch.clamp(sign * mindist, min_df, max_df)
    norm = torch.linalg.vector_norm(grad_dirs, dim=-1, keepdim=True)
    grad_dirs = grad_dirs / torch.where(norm == 0, torch.ones_like(norm), norm)
    saturated = (sdf == min_df) | (sdf == max_df)
    grad = -sign[:, None] * torch.where(saturated[:, None], torch.zeros_like(grad_dirs),
                                        grad_dirs)
    return sdf, grad


def _udf_impl(pooled, points, p_to_i, *, dmax, hfov, vfov, is_depth, is_spherical, max_df):
    """Point-to-every-pixel UDF (sdf_nmpc_tpu/data/df_computer.py:140-174).
    The (n, H W) distance matrix is built; only the argmin pixel's relative
    vector is formed."""
    B, H, W = pooled.shape
    rays = torch.as_tensor(pixel_grid(H, W, hfov, vfov, is_spherical), device=pooled.device)
    rays = rays.to(pooled.dtype).reshape(3, -1)  # (3, HW)
    img_vals = pooled.reshape(B, -1)[p_to_i]  # (n, HW)
    pix = rays[None] * img_vals[:, None] * dmax  # (n, 3, HW)
    d_p = torch.linalg.vector_norm(pix - points[:, :, None], dim=1)  # (n, HW)

    val = points[:, 0] if is_depth else torch.linalg.vector_norm(points, dim=-1)
    d_bg = dmax - val  # distance to the virtual wall at dmax
    invalid = pix[:, 0] == 0  # an invalid pixel reads the dummy distance dmax
    use_wall = d_p > d_bg[:, None]
    dist = torch.where(invalid, torch.full_like(d_p, dmax),
                       torch.where(use_wall, d_bg[:, None].expand_as(d_p), d_p))

    idx = torch.argmin(dist, dim=1)
    mindist = dist.gather(1, idx[:, None])[:, 0]
    udf = torch.clamp(mindist, 0.0, max_df)
    # the JAX package's wall quirk: a wall-closest entry carries the absolute
    # point (dmax, p_y, p_z), a small-angle stand-in for the wall's normal
    wall_vec = torch.stack([torch.full_like(val, dmax), points[:, 1], points[:, 2]], dim=-1)
    pix_sel = pix.gather(2, idx[:, None, None].expand(-1, 3, 1))[..., 0]  # (n, 3)
    grad_rel = torch.where(use_wall.gather(1, idx[:, None]), wall_vec, pix_sel - points)
    gnorm = torch.linalg.vector_norm(grad_rel, dim=-1, keepdim=True)
    zero = (udf[:, None] == max_df) | (gnorm == 0)
    grad = -torch.where(zero, torch.zeros_like(grad_rel),
                        grad_rel / torch.where(gnorm == 0, torch.ones_like(gnorm), gnorm))
    return udf, grad


def _sdf_chunk(imgs, pts, p2i, occupied, *, check, grid, distances, max_df):
    """Distance from each point of a chunk to the nearest offset voxel of the
    other occupancy (sdf_nmpc_tpu/data/df_computer.py:177-192): every
    (point, offset) pair labelled at once, ``check`` the collision
    checker's geometry.  Returns (min distance, its offset index)."""
    grid_pts = pts[:, None, :] + grid[None, :, :]  # (n, K, 3)
    occ = check_image_points_impl(imgs, grid_pts, p2i[:, None], **check)
    # a free point looks for occupied voxels, an occupied point for free ones
    target = occ != occupied[:, None]
    dists = torch.where(target, distances[None, :], torch.full_like(distances, max_df)[None])
    argmin = torch.argmin(dists, dim=1)
    return dists.gather(1, argmin[:, None])[:, 0], argmin
