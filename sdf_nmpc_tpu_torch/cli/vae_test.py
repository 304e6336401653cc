"""VAE evaluation panels: input, target, reconstruction and signed error
(counterpart of scripts/vae_test.py; reference
scripts/neural_nets/vae_test.py), PNGs, on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.vae_test --data data.h5 --vae runs/vae [--out vae_test_out]

The numerical core is ``vae_panels``; ``main`` imports matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import resolve_device


def load_vae(ckpt_dir, size_latent, H, W, batchnorm=True, device="cuda"):
    """The Vae of a train_vae run directory in eval mode: the port's
    weights.pt, or the JAX package's weights.msgpack."""
    from ..nn.vae import Vae
    from ..nn.weights import msgpack_restore, vae_from_jax

    vae = Vae(size_latent=size_latent, shape_imgs=(1, H, W), dropout_rate=0.0,
              batchnorm=batchnorm)
    d = Path(ckpt_dir)
    if (d / "weights.pt").exists():
        vae.load_state_dict(torch.load(d / "weights.pt", map_location="cpu",
                                       weights_only=True)["model"])
    else:
        tree = msgpack_restore((d / "weights.msgpack").read_bytes())
        vae.load_state_dict(vae_from_jax({k: tree[k] for k in ("params", "batch_stats")
                                          if tree.get(k)}, vae.decoder.unflatten_hw))
    return vae.eval().to(resolve_device(device))


@torch.no_grad()
def vae_panels(vae, img2d, label2d):
    """[(image (H, W) numpy, title, colour map)] of the four panels: the
    input, the collision-mapped target, the reconstruction (the latent mean
    decoded) and the reconstruction minus the target."""
    recon = vae.eval()(img2d[None, None])[0, 0]
    np_ = lambda t: t.detach().cpu().numpy()
    return [(np_(img2d), "input", "viridis"),
            (np_(label2d), "target (collision-mapped)", "viridis"),
            (np_(recon), "reconstruction", "viridis"),
            (np_(recon - label2d), "signed error", "RdBu")]


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.h5 import test_dataset_from_h5

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--data", required=True)
    ap.add_argument("--vae", required=True, help="vae checkpoint dir")
    ap.add_argument("--size-latent", type=int, default=128)
    ap.add_argument("--dmax", type=float, default=5.0)
    ap.add_argument("--n-images", type=int, default=4)
    ap.add_argument("--out", default="vae_test_out")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds, metadata = test_dataset_from_h5(args.data_dir, args.data, args.dmax, vae=True,
                                        col_map=True, device=dev)
    H, W = metadata["shape_imgs"][-2:]
    vae = load_vae(args.vae, args.size_latent, H, W, device=dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(min(args.n_images, len(ds))):
        img, label = ds[i]
        fig, axes = plt.subplots(2, 2, figsize=(12, 7))
        for ax, (data, title, cmap) in zip(axes.flat, vae_panels(vae, img[0], label[0])):
            im = ax.imshow(data, cmap=cmap)
            ax.set_title(title)
            fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(out / f"vae_img{i}.png", dpi=110)
        plt.close(fig)
        print(f"wrote {out / f'vae_img{i}.png'}")


if __name__ == "__main__":
    main()
