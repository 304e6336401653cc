"""Analytic SDF scenes and range-image rendering.

Counterpart of sdf_nmpc_tpu/sim/scenes.py: a scene is a union of spheres
and axis-aligned boxes; ``scene_sdf`` is its exact signed distance,
``make_scene_sdf_fn`` the truncated distance as a stand-in for the
NeuralDF, and ``render_range_image`` a depth camera simulated by sphere
tracing along the sensor's pixel rays (48 steps).  Scenes stack along
leading axes (``Scene.stack``), and the renderer takes such a batch at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..data.points import unit_rays


class Scene(NamedTuple):
    """sphere_c (..., S, 3), sphere_r (..., S); box_lo, box_hi (..., K, 3)."""

    sphere_c: torch.Tensor
    sphere_r: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor

    @staticmethod
    def empty(device="cuda"):
        dev = resolve_device(device)
        z = lambda *s: torch.zeros(s, device=dev)
        return Scene(sphere_c=z(0, 3), sphere_r=z(0), box_lo=z(0, 3), box_hi=z(0, 3))

    @staticmethod
    def make(spheres=(), boxes=(), device="cuda"):
        """spheres: [(center, radius)]; boxes: [(lo, hi)].  float32, as the
        JAX package builds them (an f64 scene cast from it keeps that
        rounding)."""
        dev = resolve_device(device)
        t = lambda rows, *shape: torch.as_tensor(
            np.asarray(rows, np.float32).reshape(shape), device=dev)
        return Scene(sphere_c=t([s[0] for s in spheres], -1, 3),
                     sphere_r=t([s[1] for s in spheres], -1),
                     box_lo=t([b[0] for b in boxes], -1, 3),
                     box_hi=t([b[1] for b in boxes], -1, 3))

    @staticmethod
    def stack(scenes):
        """One Scene with a leading scene axis (equal primitive counts)."""
        return Scene(*[torch.stack(xs) for xs in zip(*scenes)])

    def to(self, *args, **kw):
        return Scene(*[a.to(*args, **kw) for a in self])


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def scene_sdf(scene: Scene, p):
    """Exact signed distance from points p (..., 3) to the scene (union =
    min); the scene's leading axes broadcast against p's."""
    d = torch.full(p.shape[:-1], torch.inf, dtype=p.dtype, device=p.device)
    if scene.sphere_c.shape[-2]:
        ds = _norm(p[..., None, :] - scene.sphere_c) - scene.sphere_r
        d = torch.minimum(d, ds.amin(-1))
    if scene.box_lo.shape[-2]:
        center = 0.5 * (scene.box_lo + scene.box_hi)
        half = 0.5 * (scene.box_hi - scene.box_lo)
        q = (p[..., None, :] - center).abs() - half
        outside = _norm(torch.clamp(q, min=0.0))
        inside = torch.clamp(q.amax(-1), max=0.0)
        d = torch.minimum(d, (outside + inside).amin(-1))
    return d


def make_scene_sdf_fn(scene: Scene, max_df: float = 1.0, robot_frame=True):
    """(pos in the camera frame, latent) -> truncated SDF, usable as
    build_ocp's ``sdf``: an oracle standing in for the NeuralDF (the latent
    is ignored).  ``robot_frame`` is taken and not read, as in the JAX
    package (sim/scenes.py:69)."""

    def fn(pos, latent):
        return torch.clamp(scene_sdf(scene, pos), max=max_df)

    return fn


def render_range_image(scene: Scene, W_p_C, W_R_C, height, width, hfov, vfov, dmax,
                       is_spherical=False, n_steps: int = 48):
    """Sphere-trace the scene from a camera pose -> dmax-normalized range
    image in [0, 1]: (H, W), or (B, H, W) for a scene batch of B (its arrays
    with a leading axis).  The camera looks along its +x axis; the rays come
    from ``unit_rays`` (float32, then in W_R_C's dtype), the trace runs in W_R_C's dtype on its device."""
    W_R_C = torch.as_tensor(W_R_C)
    dt, dev = W_R_C.dtype, W_R_C.device
    rays = torch.as_tensor(unit_rays(height, width, hfov, vfov, is_spherical), device=dev)
    world_rays = (W_R_C @ rays.to(dt)).T  # (N, 3)
    origin = torch.as_tensor(W_p_C, dtype=dt, device=dev)
    batch = scene.sphere_r.dim() > 1
    if batch:  # a point axis between the scene axis and the primitives
        scene = Scene(*[a.unsqueeze(1) for a in scene])
    lead = (scene.sphere_r.shape[0],) if batch else ()
    t = torch.full(lead + (world_rays.shape[0],), 0.05, dtype=dt, device=dev)
    for _ in range(n_steps):
        p = origin + world_rays * t[..., None]
        t = torch.clamp(t + scene_sdf(scene, p), 0.0, dmax)
    rng = torch.where(t >= dmax * 0.999, torch.full_like(t, dmax), t)
    return (rng / dmax).reshape(lead + (height, width))
