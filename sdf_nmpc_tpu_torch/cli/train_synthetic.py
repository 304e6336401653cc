"""Synthetic end-to-end pipeline: an analytic scene -> its exact SDF as the
label -> NeuralDF training -> closed-loop avoidance with the LEARNED network
in the constraints (counterpart of scripts/train_synthetic.py), on the card
unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.train_synthetic [--steps 600] [--seed 0]

Everything is generated on the device: no external data.  On the card the
closed loop runs in float32 through kernels 1-4 (kernel 2's default f32x3
route for the learned network's row); on the CPU in float64, the JAX
script's default, through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from .. import resolve_device

HFOV, VFOV, DMAX = 0.7592, 0.4903, 5.0  # the reference sensor


def random_scene(rng, n_spheres=3, device="cuda"):
    """A scene of ``n_spheres`` random spheres ahead of the origin, drawn
    from the numpy Generator ``rng`` as the JAX script draws them."""
    from ..sim import Scene

    spheres = []
    for _ in range(n_spheres):
        c = [rng.uniform(1.0, 4.0), rng.uniform(-1.5, 1.5), rng.uniform(-0.8, 0.8)]
        spheres.append((c, rng.uniform(0.2, 0.6)))
    return Scene.make(spheres=spheres, device=device)


def scene_net(size_latent=8, layer_sizes=(64, 64, 64, 64), seed=0, device="cuda"):
    """The pipelines' NeuralDF: octahedral embedding, sine activations, w0 8."""
    from ..nn import NeuralDF

    return NeuralDF(size_latent=size_latent, layer_sizes=tuple(layer_sizes), embed="oct",
                    act="sin", w0=8.0,
                    generator=torch.Generator().manual_seed(seed)).to(resolve_device(device))


def scene_points(sampler, generator, batch: int):
    """Training points: half in the frustum with its margin, half in a
    1.5 m ball (the JAX step's draw)."""
    return torch.cat([sampler.sample_pos_in_frustrum(generator, batch // 2, add_margin=True),
                      sampler.sample_pos_in_ball(generator, batch // 2, 1.5)])


def sdf_update(net, optimizer, scene, pts, latent):
    """One optimizer step regressing the scene's exact SDF, clipped to
    [-0.3, 1], at the points ``pts`` (P, 3) with a fixed latent; the MSE."""
    from ..sim import scene_sdf

    gt = torch.clamp(scene_sdf(scene, pts), -0.3, 1.0)
    x = torch.cat([pts, latent.expand(pts.shape[0], -1)], dim=-1)
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((net(x)[:, 0] - gt) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_sdf_on_scene(scene, size_latent=8, layer_sizes=(64, 64, 64, 64), steps=600,
                       batch=2048, lr=3e-4, seed=0, log_every=100, log_fn=print, device="cuda",
                       timer=None):
    """Train a NeuralDF to regress the exact scene SDF over the frustum
    (Adam ``lr``, ``steps`` steps of ``batch`` points drawn by the port's
    PosSampler from a torch.Generator seeded by ``seed``).

    Returns (the network in eval mode, final loss).  ``timer``: a list that
    gets each step's seconds (the device synchronized around each)."""
    from ..data.pos_sampler import PosSampler

    dev = resolve_device(device)
    net = scene_net(size_latent, layer_sizes, seed, dev)
    sampler = PosSampler(DMAX, HFOV, VFOV, margin=30, device=dev)
    optimizer = torch.optim.Adam(net.parameters(), lr=lr)
    generator = torch.Generator(device=dev).manual_seed(seed)
    latent = torch.zeros(size_latent, device=dev)
    scene = scene.to(dev)
    loss = None
    for i in range(steps):
        tic = _sync_time(dev) if timer is not None else 0.0
        loss = sdf_update(net, optimizer, scene, scene_points(sampler, generator, batch), latent)
        if timer is not None:
            timer.append(_sync_time(dev) - tic)
        if log_every and i % log_every == 0:
            log_fn(f"  sdf step {i}: loss {float(loss):.5f}")
    return net.eval(), float(loss)


def _sync_time(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def flight_inputs(cfg, ocp, B=1, flag=1.0, latents=None, dtype=torch.float32, goal=(3.5, 0.0, 0.0)):
    """(x0 (B, nx), SolveInputs) of the pipelines' flights: hover at the
    origin, the camera at the origin looking along +x, the goal 3.5 m ahead
    with the unconstrained weights; ``flag`` and ``latents`` (B, L) per row."""
    from ..params import ParamLayout
    from ..ref_gen import Ref
    from ..solver import SolveInputs

    layout = ParamLayout.from_cfg(cfg)
    N = ocp.N
    p = np.zeros((B, N + 1, layout.np_total))
    layout.set_camera(p, np.zeros(3), np.eye(3))
    layout.set_q_d(p, [1, 0, 0, 0])
    p[..., layout.flag] = np.broadcast_to(np.asarray(flag, float), (B,))[:, None]
    if latents is not None:
        p[..., layout.latent_start:] = np.asarray(latents, float)[:, None, :]
    ref = Ref(cfg).use_constrained_weights(False)
    ref.p = np.array(goal, float)
    yr, W = ocp.pack_ref(ref)
    x0 = np.zeros((B, ocp.nx))
    x0[:, 3] = 1.0
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=ocp.device)
    return T(x0), SolveInputs(x0=T(x0), yref=T(np.tile(yr, (B, N, 1))),
                              W=T(np.tile(W, (B, N, 1))), yrefN=T(np.tile(yr[:ocp.nyN], (B, 1))),
                              WN=T(np.tile(W[:ocp.nyN], (B, 1))), p=T(p))


def frozen_copy(net, device, dtype):
    """A copy of ``net`` in eval mode on ``device`` in ``dtype``, its
    parameters out of autograd (the controller only reads them)."""
    return copy.deepcopy(net).to(device=device, dtype=dtype).eval().requires_grad_(False)


def closed_loop_rollout(scene, net, size_latent=8, n_ticks=120, qp_iters=10, dtype=None,
                        device="cuda"):
    """The ClosedLoopResult of one flight through ``scene`` with ``net``
    (a copy in ``dtype``) as the SDF row, the clearance from the exact scene
    SDF; ``dtype`` None: float32 on the card (the kernels' precision),
    float64 on the CPU (the JAX script's default)."""
    from ..config import default_config
    from ..ocp import build_ocp
    from ..sim import make_closed_loop, scene_sdf

    dev = resolve_device(device)
    dtype = dtype or ("float32" if dev.type == "cuda" else "float64")
    dt = getattr(torch, dtype)
    cfg = default_config().replace(nn=dict(size_latent=size_latent),
                                   solver=dict(dtype=dtype, qp_iters=qp_iters))
    ocp = build_ocp(cfg, sdf=frozen_copy(net, dev, dt), sdf_max_df=1.0, device=dev)
    world = scene.to(device=dev, dtype=dt)
    rollout = make_closed_loop(ocp, cfg, n_ticks=n_ticks,
                               scene_sdf_fn=lambda p: scene_sdf(world, p))
    x0, inputs = flight_inputs(cfg, ocp, dtype=dt)
    return rollout(x0, inputs)


def validate_closed_loop(scene, net, size_latent=8, n_ticks=120, qp_iters=10, dtype=None,
                         device="cuda"):
    """Fly through the scene with the LEARNED network in the constraints.

    Returns (min_clearance, tracking_error, n_failures)."""
    res = closed_loop_rollout(scene, net, size_latent, n_ticks, qp_iters, dtype, device)
    return (float(res.min_clearance[0]), float(res.tracking_error[0]),
            int(res.statuses.sum()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=120, help="closed-loop ticks")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    scene = random_scene(np.random.default_rng(args.seed), device=args.device)
    print("training NeuralDF on the analytic scene SDF ...")
    t0 = time.time()
    net, loss = train_sdf_on_scene(scene, steps=args.steps, seed=args.seed, device=args.device)
    print(f"trained in {time.time() - t0:.1f}s, final mse {loss:.5f}")

    clearance, err, fails = validate_closed_loop(scene, net, n_ticks=args.ticks,
                                                device=args.device)
    print(f"closed loop with LEARNED sdf: clearance {clearance:.3f} m, "
          f"goal error {err:.3f} m, solver failures {fails}")
    if clearance > 0 and fails == 0:
        print("OK: learned network steers collision-free")
    else:
        print("WARN: learned network did not achieve collision-free flight")


if __name__ == "__main__":
    main()
