"""Latent-conditioned SDF pipeline on synthetic scenes, the config-3 story
with LEARNED perception and no external data (counterpart of
scripts/train_latent_sdf.py), on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.train_latent_sdf [--quick | --prod] [--out DIR]

1. random analytic scenes, range images rendered from the origin;
2. the beta-VAE trained on the images (reconstruction + KLD);
3. NeuralDF trained on (position, encoder latent) -> the exact scene SDF;
4. closed loops on UNSEEN scenes: render -> encode -> frozen latent ->
   SDF-NMPC, flag on against flag off; then perception in the loop
   (re-render and re-encode every chunk), with and without recursive
   feasibility.

The SDF network can only tell scenes apart through the latent.  The closed
loops run every scene (and flag) as one batch of rollouts; each rollout is
the JAX script's single flight.  ``--out`` writes the JAX script's artifacts
(flax msgpack, latents.npy, meta.json); nothing is written without it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from .train_synthetic import DMAX, HFOV, VFOV, flight_inputs, frozen_copy, scene_net


def generate_scenes(n, seed=0, n_spheres=2, blocking=False, device="cuda"):
    """blocking=True pins the first sphere near the straight path to the goal,
    so a controller that ignores the scene MUST collide.  The draws are the
    JAX script's (numpy Generator ``seed``)."""
    from ..sim import Scene

    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(n):
        spheres = []
        for j in range(n_spheres):
            if blocking and j == 0:
                c = [rng.uniform(1.5, 2.8), rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15)]
                spheres.append((c, rng.uniform(0.35, 0.55)))
            else:
                c = [rng.uniform(1.2, 4.0), rng.uniform(-1.2, 1.2), rng.uniform(-0.6, 0.6)]
                spheres.append((c, rng.uniform(0.25, 0.55)))
        scenes.append(Scene.make(spheres=spheres, device=device))
    return scenes


def render_all(scenes, H, W, hfov, vfov, dmax):
    """(S, H, W) range images in [0, 1] from the origin, one batch."""
    from ..sim import Scene, render_range_image

    stack = Scene.stack(scenes)
    dev = stack.sphere_r.device
    return render_range_image(stack, torch.zeros(3, device=dev), torch.eye(3, device=dev), H, W,
                              hfov, vfov, dmax)


def image_vae(size_latent, H, W, seed=0, device="cuda"):
    """The pipeline's beta-VAE: no dropout, no batch norm, xavier convolutions."""
    from ..nn.initializers import apply_conv_init
    from ..nn.vae import Vae

    init = torch.Generator().manual_seed(seed)
    vae = Vae(size_latent=size_latent, shape_imgs=(1, H, W), dropout_rate=0.0, batchnorm=False,
              generator=init)
    apply_conv_init(vae, init)
    return vae.to(resolve_device(device))


def vae_config(size_latent):
    """The pipeline's VAE loss: biased masked MSE (0.1, 0.1, degree 3) + KLD, beta 1."""
    from ..training.vae import VaeTrainConfig

    return VaeTrainConfig(size_latent=size_latent, beta_kld=1.0, bias=True, bias_pos_ratio=0.1,
                          bias_dist_ratio=0.1, bias_dist_degree=3, dropout_rate=0.0,
                          batchnorm=False)


def train_vae_on_images(imgs, size_latent, epochs, log_fn=print, batch=16, lr=2e-4, seed=0):
    """Quick beta-VAE training on in-memory images (S, H, W) on their
    device (Adam, batches of 16 in a numpy-seeded order, the JAX script's);
    returns the Vae in eval mode."""
    from ..training.vae import vae_train_step

    S, H, W = imgs.shape
    dev = imgs.device
    x_all = imgs[:, None].float()
    vae = image_vae(size_latent, H, W, seed, dev)
    cfg = vae_config(size_latent)
    optimizer = torch.optim.Adam(vae.parameters(), lr=lr)
    generator = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    for ep in range(epochs):
        order = rng.permutation(S)
        parts = torch.zeros(2, device=dev)
        nb = 0
        for i in range(0, S, batch):
            idx = torch.as_tensor(order[i:i + batch], device=dev)
            xb = x_all[idx]
            parts += torch.stack(vae_train_step(vae, optimizer, xb, xb, cfg, lr, generator))
            nb += 1
        l_r, l_k = (parts / nb).tolist()
        log_fn(f"  vae epoch {ep}: recon {l_r:.3f} kld {l_k:.4f}")
    return vae.eval()


@torch.no_grad()
def encode_latents(vae, imgs):
    """(S, L) latent means of range images (S, H, W)."""
    return vae.eval().encoder(imgs[:, None].float())


def latent_scene_points(sampler, generator, batch_scenes, pts_per_scene, n_scenes):
    """(scene indices (b,), points (b, P, 3)): the JAX step's draw."""
    sidx = torch.randint(0, n_scenes, (batch_scenes,), generator=generator,
                         device=sampler.device)
    half = batch_scenes * (pts_per_scene // 2)
    pts = torch.cat([sampler.sample_pos_in_frustrum(generator, half, add_margin=True),
                     sampler.sample_pos_in_ball(generator, half, 1.5)])
    return sidx, pts.reshape(batch_scenes, pts_per_scene, 3)


def latent_sdf_update(net, optimizer, stack, latents, sidx, pts):
    """One optimizer step of NeuralDF on (pos, latent) -> the exact SDF of
    the scenes ``stack[sidx]`` (a Scene with a leading scene axis), clipped
    to [-0.3, 1], at pts (b, P, 3); the MSE."""
    from ..sim import Scene, scene_sdf

    scene_b = Scene(*[a[sidx].unsqueeze(1) for a in stack])  # a point axis after the scene's
    gt = torch.clamp(scene_sdf(scene_b, pts), -0.3, 1.0)
    b, P, _ = pts.shape
    lat_b = latents[sidx][:, None, :].expand(b, P, latents.shape[1])
    x = torch.cat([pts, lat_b], dim=-1).reshape(b * P, -1)
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((net(x)[:, 0] - gt.reshape(-1)) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_latent_sdf(scenes, latents, size_latent, layer_sizes, steps, batch_scenes,
                     pts_per_scene, seed=0, log_fn=print, lr=5e-4):
    """NeuralDF on (pos, latent) -> exact scene SDF, the scenes told apart
    only by their latent (S, L), on the latents' device.  Returns (the
    network in eval mode, final loss)."""
    from ..data.pos_sampler import PosSampler
    from ..sim import Scene

    dev = latents.device
    net = scene_net(size_latent, layer_sizes, seed, dev)
    sampler = PosSampler(DMAX, HFOV, VFOV, margin=30, device=dev)
    optimizer = torch.optim.Adam(net.parameters(), lr=lr)
    generator = torch.Generator(device=dev).manual_seed(seed)
    stack = Scene.stack(scenes).to(dev)
    lat = latents.detach().float()
    loss = None
    for i in range(steps):
        sidx, pts = latent_scene_points(sampler, generator, batch_scenes, pts_per_scene,
                                        lat.shape[0])
        loss = latent_sdf_update(net, optimizer, stack, lat, sidx, pts)
        if i % max(steps // 10, 1) == 0:
            log_fn(f"  sdf step {i}: mse {float(loss):.5f}")
    return net.eval(), float(loss)


def _eval_cfg(size_latent, rec_feas=False, device="cuda"):
    from ..config import default_config

    cfg = default_config().replace(nn=dict(size_latent=size_latent),
                                   solver=dict(dtype="float32", qp_iters=8))
    bdist_coeffs = None
    if rec_feas:
        # the braking-distance surrogate from the theory pipeline (find_amax grid + poly_fit)
        from ..theory import braking_grid, fit_poly

        vel, bdist, _ = braking_grid(cfg, vmax=3.0, step=0.25, device=device)
        bdist_coeffs = fit_poly(vel, bdist, degree=cfg.mpc.braking_dist.degree)
        cfg = cfg.replace(flags=dict(recursive_feasibility=True))
    return cfg, bdist_coeffs


def evaluate_closed_loop(test_scenes, test_latents, net, size_latent, n_ticks=100, log_fn=print,
                         device="cuda"):
    """A closed loop per unseen scene with its encoded latent, flag on and
    off (float32, 8 QP iterations), all as one batch; the statistics."""
    from ..ocp import build_ocp
    from ..sim import Scene, make_closed_loop, scene_sdf

    dev = resolve_device(device)
    cfg, _ = _eval_cfg(size_latent)
    ocp = build_ocp(cfg, sdf=frozen_copy(net, dev, torch.float32), sdf_max_df=1.0, device=dev)
    S = len(test_scenes)
    flags = np.tile([1.0, 0.0], S)  # (scene 0 on, scene 0 off, scene 1 on, ...)
    lats = np.repeat(np.asarray(torch.as_tensor(test_latents).cpu(), float), 2, axis=0)
    x0, inputs = flight_inputs(cfg, ocp, B=2 * S, flag=flags, latents=lats)
    scenes = Scene.stack([s for s in test_scenes for _ in (0, 1)]).to(dev)
    rollout = make_closed_loop(ocp, cfg, n_ticks=n_ticks,
                               scene_sdf_fn=lambda p, sc: scene_sdf(sc, p))
    res = rollout(x0, inputs, scenes)
    clear = res.min_clearance.double().cpu().numpy()
    err = res.tracking_error.double().cpu().numpy()
    fails = res.statuses.sum(1).cpu().numpy()
    on, off = flags == 1.0, flags == 0.0
    stats = {
        "scenes": S,
        "sdf_on_collision_rate": float(np.mean(clear[on] < 0)),
        "sdf_on_mean_clearance": float(np.mean(clear[on])),
        "sdf_on_mean_goal_err": float(np.mean(err[on])),
        "sdf_off_collision_rate": float(np.mean(clear[off] < 0)),
        "solver_failures": int(fails.sum()),
    }
    for k, v in stats.items():
        log_fn(f"  {k}: {v}")
    return stats


def evaluate_perception_in_loop(test_scenes, vae, net, size_latent, H, W, n_chunks=6,
                                ticks_per_chunk=15, rec_feas=False, log_fn=print, device="cuda"):
    """Every chunk re-renders each scene from its rollout's CURRENT pose,
    re-encodes it with the trained VAE and freezes the new observation: the
    deployed image-update cycle, every scene as one batch.  With
    ``rec_feas`` the braking-distance rows of recursive feasibility too."""
    from ..math import quat2rot
    from ..ocp import build_ocp
    from ..sim import Scene, make_closed_loop_perception, render_range_image, scene_sdf

    dev = resolve_device(device)
    cfg, bdist_coeffs = _eval_cfg(size_latent, rec_feas, dev)
    ocp = build_ocp(cfg, sdf=frozen_copy(net, dev, torch.float32), sdf_max_df=1.0,
                    bdist_coeffs=bdist_coeffs, device=dev)
    encoder = vae.eval().encoder

    def observe(x, sc):
        R = quat2rot(x[:, 3:7] / torch.linalg.vector_norm(x[:, 3:7], dim=-1, keepdim=True))
        imgs = torch.stack([render_range_image(Scene(*[a[b] for a in sc]), x[b, :3], R[b], H, W,
                                               HFOV, VFOV, DMAX) for b in range(x.shape[0])])
        with torch.no_grad():
            latent = encoder(imgs[:, None].float())
        return x[:, :3], R, latent

    rollout = make_closed_loop_perception(ocp, cfg, n_chunks=n_chunks,
                                          ticks_per_chunk=ticks_per_chunk, observe_fn=observe,
                                          scene_sdf_fn=lambda p, sc: scene_sdf(sc, p))
    x0, inputs = flight_inputs(cfg, ocp, B=len(test_scenes))
    res = rollout(x0, inputs, Scene.stack(test_scenes).to(dev))
    clear = res.min_clearance.double().cpu().numpy()
    tag = "refresh_recfeas" if rec_feas else "refresh"
    stats = {
        f"{tag}_collision_rate": float(np.mean(clear < 0)),
        f"{tag}_mean_clearance": float(np.mean(clear)),
        f"{tag}_mean_goal_err": float(res.tracking_error.double().mean()),
        f"{tag}_solver_failures": int(res.statuses.sum()),
    }
    for k, v in stats.items():
        log_fn(f"  {k}: {v}")
    return stats


def save_artifacts(out_dir, vae, net, lat_train, layer_sizes, meta, stats):
    """The JAX script's artifacts: flax msgpack trees of the network and the
    VAE's encoder and decoder, the first 64 training latents, meta.json
    (``meta``: latent, img, scenes, sdf_steps, vae_epochs)."""
    from ..nn.weights import decoder_to_jax, encoder_to_jax, msgpack_serialize, params_to_jax

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "sdf.msgpack").write_bytes(msgpack_serialize(params_to_jax(net.state_dict())))
    enc = encoder_to_jax(vae.encoder.state_dict())
    dec = decoder_to_jax(vae.decoder.state_dict(), vae.decoder.unflatten_hw)
    (out / "vae_encoder.msgpack").write_bytes(msgpack_serialize({"params": enc["params"]}))
    (out / "vae_decoder.msgpack").write_bytes(msgpack_serialize({"params": dec["params"]}))
    np.save(out / "latents.npy", np.asarray(torch.as_tensor(lat_train[:64]).cpu(), np.float32))
    (out / "meta.json").write_text(json.dumps(dict(
        size_latent=meta["latent"], layer_sizes=list(layer_sizes), embed="oct", act="sin", w0=8.0,
        img=meta["img"], scenes=meta["scenes"], sdf_steps=meta["sdf_steps"],
        vae_epochs=meta["vae_epochs"], stats=stats)))
    print(f"artifacts -> {out}/ (sdf.msgpack, vae_encoder/decoder.msgpack, latents.npy)")


def run(args, log_fn=print) -> dict:
    """The four stages on ``args`` (main's options); the statistics."""
    dev = resolve_device(args.device)
    H, W = (int(v) for v in args.img.split("x"))
    t0 = time.time()
    log_fn(f"[1/4] generating {args.scenes}+{args.test_scenes} scenes, rendering {H}x{W} ...")
    train_scenes = (generate_scenes(args.scenes // 2, seed=0, device=dev)
                    + generate_scenes(args.scenes - args.scenes // 2, seed=1, blocking=True,
                                      device=dev))
    test_scenes = generate_scenes(args.test_scenes, seed=999, blocking=True, device=dev)
    imgs_train = render_all(train_scenes, H, W, HFOV, VFOV, DMAX)
    imgs_test = render_all(test_scenes, H, W, HFOV, VFOV, DMAX)
    log_fn(f"    rendered in {time.time() - t0:.0f}s")

    log_fn("[2/4] training beta-VAE ...")
    vae = train_vae_on_images(imgs_train, args.latent, args.vae_epochs, log_fn=log_fn)

    log_fn("[3/4] training latent-conditioned NeuralDF ...")
    lat_train = encode_latents(vae, imgs_train)
    layer_sizes = ((32, 32, 32, 32) if args.quick else (256, 256, 256, 256) if args.prod
                   else (128, 128, 128, 128))
    net, loss = train_latent_sdf(train_scenes, lat_train, args.latent, layer_sizes=layer_sizes,
                                 steps=args.sdf_steps, batch_scenes=16, pts_per_scene=256,
                                 log_fn=log_fn)
    log_fn(f"    final train mse {loss:.5f}")

    log_fn("[4/4] closed-loop evaluation on UNSEEN scenes (render -> encode -> solve) ...")
    lat_test = encode_latents(vae, imgs_test)
    stats = evaluate_closed_loop(test_scenes, lat_test, net, args.latent,
                                 n_ticks=args.loop_ticks, log_fn=log_fn, device=dev)
    for tag, rec_feas in (("[4b] perception-in-the-loop (re-render + re-encode every chunk)",
                           False),
                          ("[4c] perception-in-the-loop WITH recursive feasibility", True)):
        log_fn(f"{tag} ...")
        stats.update(evaluate_perception_in_loop(test_scenes, vae, net, args.latent, H, W,
                                                 n_chunks=args.chunks, rec_feas=rec_feas,
                                                 log_fn=log_fn, device=dev))
    ok = (stats["sdf_on_collision_rate"] < stats["sdf_off_collision_rate"]
          and stats["sdf_on_collision_rate"] <= 0.25)
    log_fn("RESULT: " + ("OK — latent-conditioned avoidance works on unseen scenes" if ok else
                         "WARN — insufficient generalization (train longer / more scenes)"))
    stats["final_mse"] = loss
    if args.out:
        save_artifacts(args.out, vae, net, lat_train, layer_sizes,
                       dict(latent=args.latent, img=args.img, scenes=args.scenes,
                            sdf_steps=args.sdf_steps, vae_epochs=args.vae_epochs), stats)
    log_fn(f"total {time.time() - t0:.0f}s")
    return stats


def add_loop_options(ap):
    """The evaluation's lengths: the frozen-latent loop's ticks and the
    perception loops' chunks of 15 ticks."""
    ap.add_argument("--loop-ticks", type=int, default=100, help="frozen-latent closed-loop ticks")
    ap.add_argument("--chunks", type=int, default=6,
                    help="perception-in-the-loop chunks of 15 ticks")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="tiny sizes for smoke runs")
    ap.add_argument("--prod", action="store_true",
                    help="production scale: 128-latent VAE + 4x256 NeuralDF at 135x240")
    ap.add_argument("--scenes", type=int, default=192)
    ap.add_argument("--test-scenes", type=int, default=8)
    ap.add_argument("--latent", type=int, default=32)
    ap.add_argument("--vae-epochs", type=int, default=25)
    ap.add_argument("--sdf-steps", type=int, default=2500)
    ap.add_argument("--img", default="64x96")
    ap.add_argument("--out", default=None, help="write the trained weights to this directory")
    add_loop_options(ap)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.quick:
        args.scenes, args.test_scenes = 24, 3
        args.vae_epochs, args.sdf_steps = 3, 200
        args.latent = 16
    if args.prod:
        args.latent = 128
        args.img = "135x240"
        args.sdf_steps = max(args.sdf_steps, 4000)
    return args


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
