"""3-D training-point samplers and evaluation grids.

Counterpart of sdf_nmpc_tpu/data/pos_sampler.py (the reference's
PosSampler): random samplers over a box, a ball, the frustum, the frustum's
margin band and around the obstacles of an image, and deterministic grids.
Each sampler is a pure core, ``*_from_draws``, that maps its uniform /
normal / index draws to points, and a wrapper that draws them from a
``torch.Generator`` on the sampler's device.  Angle conventions as the
reference: inclination = pi/2 - elevation, radial density by r ~ U^(1/3).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .points import imgs2points


class PosSampler:
    def __init__(self, dmax, hfov, vfov, margin=20, is_spherical=False, device="cuda",
                 dtype=torch.float32):
        self.dmax = float(dmax)
        self.hfov = float(hfov)
        self.vfov = float(vfov)
        self.margin = float(margin)
        self.is_spherical = bool(is_spherical)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.atanh = np.tan(self.hfov)
        self.atanv = np.tan(self.vfov)
        # the extents with the margin (reference pos_sampler.py:24-38)
        hfov_m = min(np.pi, self.hfov * (100 + margin) / 100)
        vfov_m = min(np.pi / 2, self.vfov * (100 + margin) / 100)
        dsup_m = self.dmax * (100 + margin / 2) / 100
        self.sizes_margin = (0.0, dsup_m, dsup_m, hfov_m, vfov_m)
        self.sizes_nomargin = (0.0, self.dmax, self.dmax,
                               min(np.pi, self.hfov), min(np.pi / 2, self.vfov))

    def _sizes(self, add_margin):
        return self.sizes_margin if add_margin else self.sizes_nomargin

    def _u(self, generator, *shape):
        return torch.rand(shape, generator=generator, device=self.device, dtype=self.dtype)

    def normalize(self, points):
        """[x / dmax, y / (dmax tan hfov), z / (dmax tan vfov)]."""
        scale = torch.tensor([self.dmax, self.dmax * self.atanh, self.dmax * self.atanv],
                             dtype=points.dtype, device=points.device)
        return points / scale

    @staticmethod
    def _sph_to_xyz(r, azimuth, inclination):
        return torch.stack([r * torch.sin(inclination) * torch.cos(azimuth),
                            r * torch.sin(inclination) * torch.sin(azimuth),
                            r * torch.cos(inclination)], dim=-1)

    # ------------------------------------------------------------------ box
    def box_from_draws(self, ux, uy, uz, add_margin=False):
        dinf, dsup, drange, _, _ = self._sizes(add_margin)
        return torch.stack([ux * drange + dinf, uy * 2 * dsup - dsup, uz * 2 * dsup - dsup],
                           dim=-1)

    def sample_pos_in_box(self, generator, nb_points, add_margin=False):
        return self.box_from_draws(*(self._u(generator, nb_points) for _ in range(3)),
                                   add_margin)

    # ----------------------------------------------------------------- ball
    def ball_from_draws(self, ur, ua, ui, ball_size, add_margin=False):
        if add_margin:
            ball_size = ball_size * (100 + self.margin) / 100
        return self._sph_to_xyz(ur ** (1 / 3) * ball_size, ua * 2 * np.pi,
                                torch.arccos(ui * 2 - 1))

    def sample_pos_in_ball(self, generator, nb_points, ball_size, add_margin=False):
        return self.ball_from_draws(*(self._u(generator, nb_points) for _ in range(3)),
                                    ball_size, add_margin)

    # -------------------------------------------------------------- frustum
    def frustrum_from_draws(self, ur, ua, ui, add_margin=False):
        dinf, _, drange, hfov, vfov = self._sizes(add_margin)
        return self._sph_to_xyz(ur ** (1 / 3) * drange + dinf, (ua * 2 - 1) * hfov,
                                ui * 2 * vfov + (np.pi / 2 - vfov))

    def sample_pos_in_frustrum(self, generator, nb_points, add_margin=False):
        return self.frustrum_from_draws(*(self._u(generator, nb_points) for _ in range(3)),
                                        add_margin)

    def frustrum_margin_from_draws(self, u):
        """Boundary bands in 5 regions: +-hfov, +-vfov, +dsup (reference
        pos_sampler.py:108-152).  ``u``: 15 uniform draws, three per band,
        the last band's of length nb_points - 4 (nb_points // 5)."""
        _, dsup_m, drange_m, hfov_m, vfov_m = self.sizes_margin
        _, dsup_0, _, hfov_0, vfov_0 = self.sizes_nomargin
        parts = [
            # +hfov band
            self._sph_to_xyz(u[0] ** (1 / 3) * drange_m, u[1] * (hfov_m - hfov_0) + hfov_0,
                             u[2] * 2 * vfov_m + (np.pi / 2 - vfov_m)),
            # -hfov band
            self._sph_to_xyz(u[3] ** (1 / 3) * drange_m, -(u[4] * (hfov_m - hfov_0) + hfov_0),
                             u[5] * 2 * vfov_m + (np.pi / 2 - vfov_m)),
            # +vfov band
            self._sph_to_xyz(u[6] ** (1 / 3) * drange_m, (u[7] * 2 - 1) * hfov_m,
                             u[8] * (vfov_m - vfov_0) + (np.pi / 2 - vfov_0)),
            # -vfov band
            self._sph_to_xyz(u[9] ** (1 / 3) * drange_m, (u[10] * 2 - 1) * hfov_m,
                             u[11] * (vfov_0 - vfov_m) + (np.pi / 2 + vfov_m)),
            # +dsup band
            self._sph_to_xyz(u[12] ** (1 / 3) * (dsup_m - dsup_0) + dsup_0,
                             (u[13] * 2 - 1) * hfov_0, u[14] * 2 * vfov_0 + (np.pi / 2 - vfov_0)),
        ]
        return torch.cat(parts, dim=0)

    def sample_pos_in_frustrum_margin(self, generator, nb_points):
        n = nb_points // 5
        sizes = [n] * 12 + [nb_points - 4 * n] * 3
        return self.frustrum_margin_from_draws([self._u(generator, m) for m in sizes])

    # ------------------------------------------------------ around obstacles
    def _obstacle_points(self, imgs):
        pts = imgs2points(imgs, self.dmax, self.hfov, self.vfov, is_depth=False,
                          is_spherical=self.is_spherical, downsamp=5)
        return pts[None] if pts.dim() == 2 else pts

    def around_obs_from_draws(self, imgs, idx, noise, mode="closest", std=0.2):
        """Perturbed samples around the visible obstacle surfaces (reference
        pos_sampler.py:155-176): the points ``idx`` (mode 'random', one index
        set for every image) or each image's closest ones ('closest'), plus
        ``noise`` (standard normal, (B, n, 3)) times std."""
        pts = self._obstacle_points(imgs)
        if mode == "random":
            sel = pts[:, idx, :]
        elif mode == "closest":
            n = noise.shape[-2]
            if pts.shape[1] < n:
                raise ValueError("too few points; reduce downsamp")
            idx = torch.argsort(torch.linalg.vector_norm(pts, dim=-1), dim=-1, stable=True)
            sel = torch.take_along_dim(pts, idx[..., :n, None], dim=-2)
        else:
            raise ValueError(mode)
        out = sel + noise * std
        return out[0] if imgs.dim() == 2 else out

    def sample_pos_around_obs(self, generator, imgs, points_per_img, mode="closest", std=0.2):
        B = 1 if imgs.dim() == 2 else imgs.shape[0]
        H, W = imgs.shape[-2] // 5, imgs.shape[-1] // 5
        idx = (torch.randint(0, H * W, (points_per_img,), generator=generator,
                             device=self.device) if mode == "random" else None)
        noise = torch.randn((B, points_per_img, 3), generator=generator, device=self.device,
                            dtype=self.dtype)
        return self.around_obs_from_draws(imgs, idx, noise, mode, std)

    # ---------------------------------------------------------------- grids
    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(self.dtype)

    def grid_frustrum_slice(self, nb_points, elevation_deg, add_margin=False, h360=False):
        dinf, dsup, _, hfov, vfov = self._sizes(add_margin)
        gs = round(nb_points ** 0.5)
        if h360:
            hfov = np.pi
        r = np.repeat(np.linspace(dinf, dsup, gs), gs)
        azimuth = np.tile(np.linspace(-hfov, hfov, gs, dtype=np.float32), gs)
        inclination = np.pi / 2 - np.deg2rad(elevation_deg)
        return self._tensor(np.stack([
            r * np.sin(inclination) * np.cos(azimuth),
            r * np.sin(inclination) * np.sin(azimuth),
            r * np.cos(inclination) * np.ones_like(azimuth),
        ], axis=-1))

    def grid_frustrum(self, nb_points, add_margin=False):
        dinf, dsup, _, hfov, vfov = self._sizes(add_margin)
        gs = round(nb_points ** (1 / 3))
        r = np.repeat(np.linspace(dinf, dsup, gs), gs**2)
        azimuth = np.repeat(np.tile(np.linspace(-hfov, hfov, gs), gs), gs)
        inclination = np.tile(np.arccos(np.linspace(-np.sin(vfov), np.sin(vfov), gs)), gs**2)
        return self._tensor(np.stack([
            r * np.sin(inclination) * np.cos(azimuth),
            r * np.sin(inclination) * np.sin(azimuth),
            r * np.cos(inclination),
        ], axis=-1))

    def grid_sphere(self, nb_points, add_margin=False):
        dinf, dsup, _, _, _ = self._sizes(add_margin)
        gs = int(nb_points ** (1 / 3))
        r = np.repeat(np.linspace(dinf, dsup, gs), gs**2)
        azimuth = np.repeat(np.tile(np.linspace(-np.pi, np.pi, gs), gs), gs)
        inclination = np.tile(np.arccos(np.linspace(-1, 1, gs)), gs**2)
        return self._tensor(np.stack([
            r * np.sin(inclination) * np.cos(azimuth),
            r * np.sin(inclination) * np.sin(azimuth),
            r * np.cos(inclination),
        ], axis=-1))

    def grid_sphere_fixed_step(self, step, in_frustrum=False, frustrum_is_spherical=False,
                               add_margin=False):
        dinf, dsup, _, hfov, vfov = self._sizes(add_margin)
        dsup = np.round(dsup / step) * step
        x = np.arange(-dsup, dsup * 1.001, step)
        pts = np.stack(np.meshgrid(x, x, x, indexing="ij"), axis=-1).reshape(-1, 3)
        pts = np.unique(pts, axis=0)
        if in_frustrum:
            pts = pts[np.linalg.norm(pts, axis=1) <= dsup * 1.001]
            pts = pts[np.abs(np.arctan2(pts[:, 1], pts[:, 0])) <= hfov * 1.001]
            if frustrum_is_spherical:
                el = np.arctan2(pts[:, 2], np.linalg.norm(pts[:, :2], axis=1))
            else:
                el = np.arctan2(pts[:, 2], pts[:, 0])
            pts = pts[np.abs(el) <= vfov * 1.001]
        return self._tensor(pts)
