"""Seeded depth frames for the perception cells: scenes of spheres above a
floor, seen by a pinhole depth camera at the origin looking along +x (y to
the left, z up), rendered by exact ray-sphere and ray-plane intersection.

A frame is uint16 millimetres of depth (distance along the optical axis),
0 where a ray hits nothing within ``dmax``, as a depth camera reports it.
Pixel (v, u) looks along (1, tan(hfov) (1 - 2u/W), tan(vfov) (1 - 2v/H)),
the projection the port's ``depth2range`` map assumes.
"""

from __future__ import annotations

import numpy as np
import torch


def draw_scenes(n: int, spheres: int, seed) -> dict:
    """Sphere centres (n, k, 3) and radii (n, k), and floor heights (n,),
    from the seed."""
    rng = np.random.default_rng(seed)
    centres = np.stack([rng.uniform(0.8, 5.0, (n, spheres)), rng.uniform(-2.0, 2.0, (n, spheres)),
                        rng.uniform(-0.8, 0.8, (n, spheres))], -1)
    return dict(centres=centres, radii=rng.uniform(0.15, 0.7, (n, spheres)),
                floor=rng.uniform(-1.2, -0.6, n))


def render(scenes: dict, shape, hfov: float, vfov: float, dmax: float, device,
           chunk: int = 64) -> torch.Tensor:
    """uint16 depth frames (n, 1, H, W) in millimetres, on ``device``."""
    H, W = shape
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.arange(W, **f64)
    v = torch.arange(H, **f64)
    th = np.tan(hfov) * (1 - 2 * u / W)
    tv = np.tan(vfov) * (1 - 2 * v / H)
    d = torch.stack([torch.ones(H, W, **f64), th[None, :].expand(H, W),
                     tv[:, None].expand(H, W)], -1)  # (H, W, 3), d_x = 1: t is the depth
    dd = (d * d).sum(-1)
    out = []
    n = len(scenes["radii"])
    for i in range(0, n, chunk):
        c = torch.as_tensor(scenes["centres"][i:i + chunk], **f64)  # (m, k, 3)
        r = torch.as_tensor(scenes["radii"][i:i + chunk], **f64)
        fl = torch.as_tensor(scenes["floor"][i:i + chunk], **f64)
        # |t d - c|^2 = r^2: t = (b - sqrt(b^2 - dd (cc - r^2))) / dd, b = d.c
        b = torch.einsum("hwx,mkx->mkhw", d, c)
        cc = (c * c).sum(-1) - r * r
        disc = b * b - dd * cc[..., None, None]
        t = (b - torch.sqrt(torch.clamp(disc, min=0.0))) / dd
        t = torch.where((disc >= 0) & (t > 0), t, torch.full_like(t, np.inf)).amin(1)
        # the floor z = fl: t = fl / d_z where d_z < 0
        dz = d[..., 2]
        tf = torch.where(dz < 0, fl[:, None, None] / torch.where(dz < 0, dz, -1.0), np.inf)
        t = torch.minimum(t, tf)
        mm = torch.where(t <= dmax, torch.round(t * 1000.0), torch.zeros_like(t))
        out.append(mm.to(torch.int32).to(torch.uint16)[:, None])
    return torch.cat(out)
