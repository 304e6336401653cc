"""Production perception training at the reference's fidelity on the port's
data and training engine (counterpart of scripts/train_prod_perception.py),
on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.train_prod_perception data vae df save eval
    python -m sdf_nmpc_tpu_torch.cli.train_prod_perception data vae df save eval --smoke

  data : analytic scenes -> 270x480 depth images (mm) -> prod_depth.npz, the
         reference's h5 layout of train / test groups as an .npz
         (data/h5.py::write_image_dataset)
  vae  : train_dataset_from_h5(vae=True, col_map=True) -> training/vae.py
  df   : the frozen encoder's sampled latents, mixed-region points, the
         image-based GT and the composite loss -> training/df.py
  save : the JAX stage's artifacts: sdf.msgpack, vae_encoder.msgpack,
         vae_decoder.msgpack (flax msgpack), latents.npy, meta.json
  eval : closed loops on UNSEEN blocking scenes, frozen / refresh /
         refresh + recursive feasibility; the stats merged into meta.json

Stages are independent and resumable.  The run directory defaults to
runs/prod_perception (--smoke: runs/prod_perception_smoke) and the
artifacts to <workdir>/weights: never the repository's weights/.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from .train_latent_sdf import (add_loop_options, evaluate_closed_loop,
                               evaluate_perception_in_loop, generate_scenes, render_all)
from .train_synthetic import DMAX, HFOV, VFOV

DATASET = "prod_depth.npz"  # the data stage's file in the run directory


def _depth_factor(H, W):
    """The JAX stage's per-pixel range -> depth factor, depth2range of an
    image of ones.  depth2range clips to [0, 1], so the factor is 1 and the
    stored "depth" is the range: kept as the JAX script has it."""
    from ..perception.preprocessing import depth2range

    return depth2range(torch.ones(H, W), HFOV, VFOV).numpy()


def _yaw_rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def stage_data(args):
    """Scenes -> rendered depth images (mm) -> a train / test dataset."""
    from ..data.h5 import write_image_dataset
    from ..sim import render_range_image

    dev = resolve_device(args.device)
    H, W = args.H, args.W
    factor = _depth_factor(H, W)
    n = args.scenes
    train_scenes = (generate_scenes(n // 2, seed=0, device=dev)
                    + generate_scenes(n - n // 2, seed=1, blocking=True, device=dev))
    test_scenes = generate_scenes(args.test_scenes, seed=999, blocking=True, device=dev)

    def render_set(scenes, poses_per_scene, seed):
        rng = np.random.default_rng(seed)
        out = []
        for sc in scenes:
            for j in range(poses_per_scene):
                if j == 0:
                    p, R = np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
                elif args.pose_mode == "traj":  # viewpoints along the flight corridor
                    p = rng.uniform([0.0, -0.6, -0.35], [2.8, 0.6, 0.35]).astype(np.float32)
                    R = _yaw_rot(rng.uniform(-0.45, 0.45))
                else:  # 'jitter': small pose jitter around the origin
                    p = rng.uniform([-0.3, -0.3, -0.15], [0.3, 0.3, 0.15]).astype(np.float32)
                    R = _yaw_rot(rng.uniform(-0.15, 0.15))
                img = render_range_image(sc, torch.as_tensor(p, device=dev),
                                         torch.as_tensor(R, device=dev), H, W, HFOV, VFOV, DMAX)
                depth_mm = img.cpu().numpy() * DMAX / factor * 1000.0  # range -> depth, m -> mm
                out.append(depth_mm.astype(np.float32)[None])  # (1, H, W)
        return np.stack(out)

    t0 = time.time()
    imgs_train = render_set(train_scenes, args.poses, seed=10)
    imgs_test = render_set(test_scenes, 1, seed=11)
    print(f"rendered {len(imgs_train)}+{len(imgs_test)} images {H}x{W} in {time.time() - t0:.0f}s")
    path = Path(args.workdir) / DATASET
    path.parent.mkdir(parents=True, exist_ok=True)
    write_image_dataset(path, imgs_train, imgs_test, dict(
        hfov=HFOV, vfov=VFOV, aspect_ratio=W / H, is_depth=True, is_spherical=False))
    print(f"dataset -> {path}")


def stage_vae(args):
    from ..data.h5 import train_dataset_from_h5
    from ..training import VaeTrainConfig, train_vae

    (train_ds, valid_ds), metadata = train_dataset_from_h5(
        args.workdir, DATASET, DMAX, train_valid_ratio=0.9, vae=True,
        col_map=True, device=args.device)
    cfg = VaeTrainConfig(size_latent=args.latent, nb_epochs=args.vae_epochs,
                         batch_size=args.vae_batch)
    out = Path(args.workdir) / "vae_ckpt"
    out.mkdir(parents=True, exist_ok=True)
    _, history = train_vae(train_ds, valid_ds, metadata, out, cfg=cfg, device=args.device)
    (out / "history.json").write_text(json.dumps(history))


def _df_dir(args) -> Path:
    return Path(args.workdir) / f"df_ckpt_{'_'.join(map(str, args.layers))}"


def stage_df(args):
    from ..data.h5 import train_dataset_from_h5
    from ..training import DfTrainConfig, load_encoder_from_vae_ckpt, train_df

    (train_ds, valid_ds), metadata = train_dataset_from_h5(
        args.workdir, DATASET, DMAX, train_valid_ratio=0.9, vae=False,
        device=args.device)
    encoder = load_encoder_from_vae_ckpt(Path(args.workdir) / "vae_ckpt", args.latent,
                                         device=args.device)
    cfg = DfTrainConfig(dmax=DMAX, nb_epochs=args.df_epochs, batch_size=args.df_batch,
                        points_per_img=args.points_per_img, lr_start=args.df_lr,
                        lr_nb_steps=args.df_lr_steps)
    out = _df_dir(args)
    out.mkdir(parents=True, exist_ok=True)
    _, history = train_df(train_ds, valid_ds, metadata, encoder, out, cfg=cfg,
                          nn_kwargs={"layer_sizes": tuple(args.layers), "w0": args.w0,
                                     "dropout_rate": 0.0},
                          size_latent=args.latent, restart_from_epoch=args.restart_from_epoch,
                          device=args.device)
    (out / "history.json").write_text(json.dumps(history))


def load_trained(args):
    """(Vae, NeuralDF) in eval mode from the vae and df stages' checkpoints
    (the df checkpoint of epoch --df-ckpt-epoch, else the latest)."""
    from ..nn import NeuralDF
    from ..nn.vae import Vae
    from ..training import load_checkpoint

    dev = resolve_device(args.device)
    vae = Vae(size_latent=args.latent, shape_imgs=(1, args.H, args.W), dropout_rate=0.0,
              batchnorm=True).to(dev)
    load_checkpoint(Path(args.workdir) / "vae_ckpt", vae)
    df = NeuralDF(size_latent=args.latent, layer_sizes=tuple(args.layers), embed="oct",
                  act="sin", w0=args.w0, dropout_rate=0.0).to(dev)
    load_checkpoint(_df_dir(args), df, epoch=args.df_ckpt_epoch)
    return vae.eval(), df.eval()


@torch.no_grad()
def _encode(vae, imgs01):
    """Range images in [0, 1] (S, H, W) -> latent means."""
    return vae.encoder(imgs01[:, None])


def stage_save(args):
    """The artifacts the benches and the accuracy workload read."""
    from ..nn.weights import decoder_to_jax, encoder_to_jax, msgpack_serialize, params_to_jax

    vae, df = load_trained(args)
    dev = resolve_device(args.device)
    n = args.scenes
    train_scenes = (generate_scenes(n // 2, seed=0, device=dev)
                    + generate_scenes(n - n // 2, seed=1, blocking=True, device=dev))
    lats = _encode(vae, render_all(train_scenes[:64], args.H, args.W, HFOV, VFOV, DMAX))

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "sdf.msgpack").write_bytes(msgpack_serialize(params_to_jax(df.state_dict())))
    (out / "vae_encoder.msgpack").write_bytes(msgpack_serialize(
        encoder_to_jax(vae.encoder.state_dict())))
    (out / "vae_decoder.msgpack").write_bytes(msgpack_serialize(
        decoder_to_jax(vae.decoder.state_dict(), vae.decoder.unflatten_hw)))
    np.save(out / "latents.npy", lats.cpu().numpy().astype(np.float32))
    meta = dict(
        size_latent=args.latent, layer_sizes=list(args.layers), embed="oct", act="sin",
        w0=args.w0, img=f"{args.H}x{args.W}", scenes=args.scenes, batchnorm=True,
        pipeline="h5+augment+composite",
        loss="sign-weighted regression + grad MSE + direction + eikonal (50/0/1:60/5)",
        vae_epochs=args.vae_epochs, df_epochs=args.df_epochs, pose_mode=args.pose_mode,
        poses=args.poses, df_lr=args.df_lr, df_lr_steps=args.df_lr_steps,
        points_per_img=args.points_per_img, df_ckpt_epoch=args.df_ckpt_epoch)
    mf = out / "meta.json"
    if mf.exists():  # keep the stats of an earlier eval stage
        old = json.loads(mf.read_text())
        if "stats" in old:
            meta["stats"] = old["stats"]
    mf.write_text(json.dumps(meta))
    print(f"artifacts -> {out}/")


def stage_eval(args) -> dict:
    """Closed loops on UNSEEN scenes: frozen / refresh / rec-feas; the stats."""
    vae, df = load_trained(args)
    dev = resolve_device(args.device)
    test_scenes = generate_scenes(args.test_scenes, seed=999, blocking=True, device=dev)
    lat_test = _encode(vae, render_all(test_scenes, args.H, args.W, HFOV, VFOV, DMAX))
    print("[frozen] latent from the origin view, frozen for the run")
    stats = evaluate_closed_loop(test_scenes, lat_test, df, args.latent, n_ticks=args.loop_ticks,
                                 device=dev)
    for tag, rec_feas in (("[refresh] re-render + re-encode every chunk", False),
                          ("[refresh + recursive feasibility]", True)):
        print(tag)
        stats.update(evaluate_perception_in_loop(test_scenes, vae, df, args.latent, args.H,
                                                 args.W, n_chunks=args.chunks, rec_feas=rec_feas,
                                                 device=dev))
    mf = Path(args.out) / "meta.json"
    mf.parent.mkdir(parents=True, exist_ok=True)
    meta = json.loads(mf.read_text()) if mf.exists() else {}
    meta["stats"] = stats
    mf.write_text(json.dumps(meta))
    print(f"stats -> {mf}")
    return stats


STAGES = {"data": stage_data, "vae": stage_vae, "df": stage_df, "save": stage_save,
          "eval": stage_eval}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stages", nargs="+", choices=list(STAGES))
    ap.add_argument("--workdir", default=None,
                    help="run directory (default runs/prod_perception, --smoke "
                         "runs/prod_perception_smoke)")
    ap.add_argument("--out", default=None, help="artifacts directory (default <workdir>/weights)")
    ap.add_argument("--img", default="270x480")
    ap.add_argument("--scenes", type=int, default=256)
    ap.add_argument("--test-scenes", type=int, default=8)
    ap.add_argument("--poses", type=int, default=2, help="camera poses per scene")
    ap.add_argument("--pose-mode", choices=["jitter", "traj"], default="traj",
                    help="extra-pose distribution: 'traj' samples the flight corridor, "
                         "'jitter' the origin's surroundings")
    ap.add_argument("--latent", type=int, default=128)
    ap.add_argument("--layers", type=int, nargs="+", default=[256, 256, 256, 256])
    ap.add_argument("--w0", type=float, default=20.0)
    ap.add_argument("--vae-epochs", type=int, default=40)
    ap.add_argument("--vae-batch", type=int, default=16)
    ap.add_argument("--df-epochs", type=int, default=40)
    ap.add_argument("--df-batch", type=int, default=16)
    # the reference trains 200 epochs at 5e-5 (df_train.py); a compressed
    # epoch budget takes a proportionally hotter cosine schedule
    ap.add_argument("--df-lr", type=float, default=5e-5)
    ap.add_argument("--df-lr-steps", type=int, default=20)
    ap.add_argument("--df-ckpt-epoch", type=int, default=None,
                    help="save/eval from this epoch's checkpoint (default: the latest)")
    ap.add_argument("--points-per-img", type=int, default=2500)
    ap.add_argument("--restart-from-epoch", type=int, default=0)
    add_loop_options(ap)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for a smoke run of every stage")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.smoke:
        args.img = "45x80"
        args.scenes, args.test_scenes, args.poses = 12, 2, 1
        args.latent = 16
        args.layers = [32, 32, 32, 32]
        args.vae_epochs = args.df_epochs = 2
        args.vae_batch = args.df_batch = 4
        args.points_per_img = 100
    if args.workdir is None:
        args.workdir = "runs/prod_perception_smoke" if args.smoke else "runs/prod_perception"
    if args.out is None:
        args.out = str(Path(args.workdir) / "weights")
    args.H, args.W = (int(v) for v in args.img.split("x"))
    return args


def main(argv=None):
    args = parse_args(argv)
    for st in args.stages:
        print(f"===== stage {st} =====", flush=True)
        t0 = time.time()
        STAGES[st](args)
        print(f"===== stage {st} done in {time.time() - t0:.0f}s =====", flush=True)


if __name__ == "__main__":
    main()
