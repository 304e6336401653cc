"""Sphere-trace the network's zero level set along the pixel rays and
re-render a range image beside the input (counterpart of
scripts/df_viz_img.py; reference scripts/neural_nets/df_viz_img.py:85-97,
every ray at once), PNGs, on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.df_viz_img --data data.h5 --sdf runs/sdf/VARIANT \\
        --encoder runs/vae [--out df_viz_img_out]

The numerical cores are ``sphere_trace`` and ``trace_image``; ``main``
imports matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from .df_test import load_sdf, with_latent


def sphere_trace(sdf_batch_fn, rays, t0=0.05, n_steps=40, t_max=5.0):
    """March all rays (N, 3) from the origin together: t <- clip(t + sdf(t d),
    t0, t_max), ``n_steps`` times; the distances t (N,)."""
    t = torch.full(rays.shape[:1], t0, dtype=rays.dtype, device=rays.device)
    for _ in range(n_steps):
        t = torch.clamp(t + sdf_batch_fn(rays * t[:, None]), t0, t_max)
    return t


def pixel_rays(h, w, hfov, vfov, is_spherical, dtype=torch.float32, device="cuda"):
    """(h w, 3) unit rays of the sensor's pixel grid."""
    from ..data.points import pixel_grid

    rays = pixel_grid(h, w, hfov, vfov, is_spherical).reshape(3, -1).T
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return torch.as_tensor(rays, dtype=dtype, device=resolve_device(device))


@torch.no_grad()
def trace_image(net, latent, h, w, hfov, vfov, is_spherical, dmax):
    """The network's range image (h, w) in [0, 1], by sphere tracing."""
    rays = pixel_rays(h, w, hfov, vfov, is_spherical, latent.dtype, latent.device)
    t = sphere_trace(lambda p: net(with_latent(p, latent))[:, 0], rays, t_max=dmax)
    return t.reshape(h, w) / dmax


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.h5 import test_dataset_from_h5
    from ..training import load_encoder_from_vae_ckpt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--data", required=True)
    ap.add_argument("--sdf", required=True)
    ap.add_argument("--encoder", required=True)
    ap.add_argument("--layer-sizes", default="256_256_128_64")
    ap.add_argument("--size-latent", type=int, default=128)
    ap.add_argument("--dmax", type=float, default=5.0)
    ap.add_argument("--downsamp", type=int, default=5)
    ap.add_argument("--n-images", type=int, default=2)
    ap.add_argument("--out", default="df_viz_img_out")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds, metadata = test_dataset_from_h5(args.data_dir, args.data, args.dmax, device=dev)
    net = load_sdf(args.sdf, args.size_latent, [int(v) for v in args.layer_sizes.split("_")],
                   device=dev)
    encoder = load_encoder_from_vae_ckpt(args.encoder, args.size_latent, device=dev)
    H, W = metadata["shape_imgs"][-2:]
    h, w = H // args.downsamp, W // args.downsamp
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(min(args.n_images, len(ds))):
        img, _ = ds[i]
        with torch.no_grad():
            latent = encoder(img[None])[0]
        rendered = trace_image(net, latent, h, w, metadata["hfov"], metadata["vfov"],
                               metadata["is_spherical"], args.dmax).cpu().numpy()
        fig, axes = plt.subplots(1, 2, figsize=(12, 4))
        axes[0].imshow(img[0].cpu().numpy(), cmap="viridis", vmin=0, vmax=1)
        axes[0].set_title("input range image")
        axes[1].imshow(rendered, cmap="viridis", vmin=0, vmax=1)
        axes[1].set_title("sphere-traced neural SDF")
        fig.tight_layout()
        fig.savefig(out / f"render_img{i}.png", dpi=110)
        plt.close(fig)
        print(f"wrote {out / f'render_img{i}.png'}")


if __name__ == "__main__":
    main()
