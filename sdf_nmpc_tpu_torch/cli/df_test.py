"""SDF-network evaluation: per-elevation frustum slices of the network
against the image-based ground truth (counterpart of scripts/df_test.py;
reference scripts/neural_nets/df_test.py), PNGs, on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.df_test --data data.h5 --sdf runs/sdf/VARIANT \\
        --encoder runs/vae [--out df_test_out]

The numerical core is ``frustum_slices``; ``main`` imports matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device


def load_sdf(ckpt_dir, size_latent, layer_sizes, w0=20.0, device="cuda"):
    """The NeuralDF (octahedral embedding, sine w0) of a train_df run
    directory, in eval mode: the port's weights.pt, or the JAX package's
    weights.msgpack (the flax variables under "params")."""
    from ..nn import NeuralDF
    from ..nn.weights import msgpack_restore, params_from_jax

    net = NeuralDF(size_latent=size_latent, layer_sizes=tuple(layer_sizes), embed="oct",
                   act="sin", w0=w0)
    d = Path(ckpt_dir)
    if (d / "weights.pt").exists():
        net.load_state_dict(torch.load(d / "weights.pt", map_location="cpu",
                                       weights_only=True)["model"])
    else:
        net.load_state_dict(params_from_jax(msgpack_restore(
            (d / "weights.msgpack").read_bytes())["params"]))
    return net.eval().to(resolve_device(device))


def with_latent(pts, latent):
    """[pts | latent] rows for the network: pts (P, 3), latent (L,)."""
    return torch.cat([pts, latent.to(pts.dtype).expand(pts.shape[0], -1)], dim=-1)


def frustum_slices(net, latent, img2d, df_cpt, sampler, elevations, n_points=4900):
    """For each elevation (degrees): a dict of the (g, g) grids X, Y and the
    ground-truth and network distances ('gt', 'nn') on the frustum slice of
    ``n_points`` points (numpy)."""
    rows = []
    for elev in elevations:
        pts = sampler.grid_frustrum_slice(n_points, elev)
        gt, _ = df_cpt.get_df(img2d, pts)
        with torch.no_grad():
            pred = net(with_latent(pts.to(latent.dtype), latent))[:, 0]
        g = int(np.sqrt(pts.shape[0]))
        grid = lambda a: a.detach().cpu().numpy().reshape(g, g)
        rows.append({"elevation": float(elev), "X": grid(pts[:, 0]), "Y": grid(pts[:, 1]),
                     "gt": grid(gt), "nn": grid(pred)})
    return rows


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
    ap.add_argument("--sdf", required=True, help="sdf checkpoint dir")
    ap.add_argument("--encoder", required=True, help="encoder (train_vae run) dir")
    ap.add_argument("--layer-sizes", default="256_256_128_64")
    ap.add_argument("--size-latent", type=int, default=128)
    ap.add_argument("--dmax", type=float, default=5.0)
    ap.add_argument("--elevations", default="-15,0,15")
    ap.add_argument("--n-images", type=int, default=3)
    ap.add_argument("--n-points", type=int, default=4900, help="points per slice (a square)")
    ap.add_argument("--out", default="df_test_out")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds, metadata = test_dataset_from_h5(args.data_dir, args.data, args.dmax, device=dev)
    net = load_sdf(args.sdf, args.size_latent, [int(v) for v in args.layer_sizes.split("_")],
                   device=dev)
    encoder = load_encoder_from_vae_ckpt(args.encoder, args.size_latent, device=dev)
    df_cpt = DfComputer(True, args.dmax, metadata["hfov"], metadata["vfov"], 1.0,
                        is_spherical=metadata["is_spherical"], device=dev)
    sampler = PosSampler(args.dmax, metadata["hfov"], metadata["vfov"],
                         is_spherical=metadata["is_spherical"], device=dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    elevations = [float(e) for e in args.elevations.split(",")]
    for i in range(min(args.n_images, len(ds))):
        img, _ = ds[i]  # (1, H, W)
        with torch.no_grad():
            latent = encoder(img[None])[0]
        rows = frustum_slices(net, latent, img[0], df_cpt, sampler, elevations, args.n_points)
        fig, axes = plt.subplots(len(rows), 2, figsize=(10, 4 * len(rows)), squeeze=False)
        for r, row in enumerate(rows):
            for c, name in enumerate(("gt", "nn")):
                ax = axes[r, c]
                cf = ax.contourf(row["X"], row["Y"], row[name], levels=15, cmap="RdBu")
                ax.contour(row["X"], row["Y"], row[name], levels=[0.0], colors="k")
                ax.set_title(f"{name.upper()} slice elev {row['elevation']} deg")
                fig.colorbar(cf, ax=ax)
        fig.tight_layout()
        fig.savefig(out / f"slices_img{i}.png", dpi=110)
        plt.close(fig)
        print(f"wrote {out / f'slices_img{i}.png'}")


if __name__ == "__main__":
    main()
