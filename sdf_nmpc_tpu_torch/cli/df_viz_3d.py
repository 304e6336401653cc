"""3-D closest-point projections x - d(x) * grad d(x) / |grad d(x)| of the
network against the image-based ground truth (counterpart of
scripts/df_viz_3d.py; reference scripts/neural_nets/df_viz_3D.py:91-117), a
PNG, on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.df_viz_3d --data data.h5 --sdf runs/sdf/VARIANT \\
        --encoder runs/vae [--out df_viz_3d_out]

The numerical core is ``closest_points``; ``main`` imports matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import resolve_device
from .df_test import load_sdf, with_latent


def project(pts, df, grad):
    """pts - df * grad / |grad| (a zero gradient taken as is)."""
    n = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    return pts - df[:, None] * grad / torch.where(n == 0, torch.ones_like(n), n)


def value_and_grad(net, latent, pts):
    """The network's distance (P,) at pts (P, 3) and its gradient in pts."""
    x = pts.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        d = net(with_latent(x, latent))[:, 0]
        (g,) = torch.autograd.grad(d.sum(), x)
    return d.detach(), g


def closest_points(net, latent, pts, img2d, df_cpt):
    """(ground-truth projections, network projections, mask of the
    unsaturated ground-truth points) of pts (P, 3); the ground-truth
    gradient points away from the surface, so it is negated."""
    gt_df, gt_grad = df_cpt.get_df(img2d, pts)
    nn_df, nn_grad = value_and_grad(net, latent, pts.to(latent.dtype))
    proj_gt = project(pts, gt_df.to(pts.dtype), -gt_grad.to(pts.dtype))
    return proj_gt, project(pts.to(latent.dtype), nn_df, nn_grad), gt_df < 0.99


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data import DfComputer, PosSampler
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
    ap.add_argument("--n-points", type=int, default=3000)
    ap.add_argument("--out", default="df_viz_3d_out")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds, metadata = test_dataset_from_h5(args.data_dir, args.data, args.dmax, device=dev)
    net = load_sdf(args.sdf, args.size_latent, [int(v) for v in args.layer_sizes.split("_")],
                   device=dev)
    encoder = load_encoder_from_vae_ckpt(args.encoder, args.size_latent, device=dev)
    df_cpt = DfComputer(True, args.dmax, metadata["hfov"], metadata["vfov"], 1.0,
                        is_spherical=metadata["is_spherical"], device=dev)
    sampler = PosSampler(args.dmax, metadata["hfov"], metadata["vfov"], device=dev)
    img, _ = ds[0]
    with torch.no_grad():
        latent = encoder(img[None])[0]
    pts = sampler.sample_pos_in_frustrum(torch.Generator(device=dev).manual_seed(0), args.n_points)
    proj_gt, proj_nn, mask = closest_points(net, latent, pts, img[0], df_cpt)
    fig = plt.figure(figsize=(12, 5))
    for k, (proj, name) in enumerate([(proj_gt, "GT"), (proj_nn, "NN")]):
        p = proj[mask].detach().cpu().numpy()
        ax = fig.add_subplot(1, 2, k + 1, projection="3d")
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2)
        ax.set_title(f"{name} closest-point projections")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fig.savefig(out / "closest_points.png", dpi=110)
    print(f"wrote {out / 'closest_points.png'}")


if __name__ == "__main__":
    main()
