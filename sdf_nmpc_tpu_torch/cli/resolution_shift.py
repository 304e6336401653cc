"""The encoder's resolution-shift risk (counterpart of
scripts/resolution_shift.py), on the card unless ``--device cpu``:

    python -m sdf_nmpc_tpu_torch.cli.resolution_shift [--alt 135x240] [--scenes 8] [--device cpu]

The encoder's adaptive pooling takes any input resolution, so an image at a
resolution the encoder was not trained at is encoded without an error: the
latent distribution shifts instead.  The same blocking scenes are rendered
at the trained resolution and at an alternate one, both are encoded by the
trained encoder (``weights/``), and the latent drift is reported, then the
trained NeuralDF's drift over 2,048 frustum points between the two latents
and the share of points whose side of the collision bound flips.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

HFOV, VFOV, DMAX = 0.7592, 0.4903, 5.0  # the JAX script's camera
N_POINTS = 2048
MARGIN = 0.22 + 0.05  # robot.xy + bound_margin scale


def run(alt=(135, 240), scenes: int = 8, device="cuda", points=None,
        dtype=torch.float32) -> dict:
    """The drift statistics of ``scenes`` blocking scenes (seed 999) between
    the trained resolution and ``alt`` (H, W).  ``points`` (P, 3): the
    frustum points of the NeuralDF drift, else 2,048 drawn from a
    ``torch.Generator`` seeded 0."""
    from .. import resolve_device
    from ..data.pos_sampler import PosSampler
    from ..nn.weights import load_prod_encoder, load_prod_sdf, meta_img_shape
    from ..sim import Scene, render_range_image
    from .train_latent_sdf import generate_scenes

    dev = resolve_device(device)
    loaded = load_prod_encoder(device=dev)
    if loaded is None:
        raise SystemExit("no trained encoder in weights/")
    enc, meta = loaded
    enc = enc.to(dtype)
    Ht, Wt = meta_img_shape(meta)
    Ha, Wa = (int(v) for v in alt)
    print(f"trained resolution {Ht}x{Wt}; alternate {Ha}x{Wa}")
    stack = Scene.stack(generate_scenes(scenes, seed=999, blocking=True, device=dev)).to(dtype)

    @torch.no_grad()
    def encode_at(H, W):
        imgs = render_range_image(stack, torch.zeros(3, dtype=dtype, device=dev),
                                  torch.eye(3, dtype=dtype, device=dev), H, W, HFOV, VFOV, DMAX)
        return enc(imgs[:, None]).double().cpu().numpy()

    lat_t, lat_a = encode_at(Ht, Wt), encode_at(Ha, Wa)
    l2 = np.linalg.norm(lat_a - lat_t, axis=1)
    scale = np.linalg.norm(lat_t, axis=1)
    cos = np.sum(lat_a * lat_t, axis=1) / (np.linalg.norm(lat_a, axis=1) * scale + 1e-12)
    out = {"trained": (Ht, Wt), "alt": (Ha, Wa), "rel_l2_mean": float(np.mean(l2 / scale)),
           "rel_l2_max": float(np.max(l2 / scale)), "cos_mean": float(np.mean(cos)),
           "cos_min": float(np.min(cos))}
    print(f"latent drift:   rel L2 mean {out['rel_l2_mean']:.3f}  max {out['rel_l2_max']:.3f}   "
          f"cosine mean {out['cos_mean']:.4f}  min {out['cos_min']:.4f}")

    net = load_prod_sdf(device=dev)
    if net is None:
        return out
    net = net.to(dtype)
    if points is None:
        sampler = PosSampler(DMAX, HFOV, VFOV, margin=30, device=dev, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        points = sampler.sample_pos_in_frustrum(gen, N_POINTS)
    pts = torch.as_tensor(points, dtype=dtype, device=dev)

    @torch.no_grad()
    def df_of(lat):
        lat = torch.as_tensor(lat, dtype=dtype, device=dev)
        x = torch.cat([pts[None].expand(lat.shape[0], -1, -1),
                       lat[:, None].expand(-1, pts.shape[0], -1)], -1)
        return net(x.reshape(-1, x.shape[-1]))[:, 0].double().cpu().numpy()

    df_t, df_a = df_of(lat_t), df_of(lat_a)
    d = np.abs(df_a - df_t)
    flips = float(np.mean((df_t > MARGIN) != (df_a > MARGIN)))
    out.update(df_mean=float(d.mean()), df_p95=float(np.percentile(d, 95)), df_max=float(d.max()),
               df_range=(float(df_t.min()), float(df_t.max())), flip_share=flips)
    print(f"NeuralDF drift: mean {out['df_mean']:.4f} m  p95 {out['df_p95']:.4f} m  "
          f"max {out['df_max']:.4f} m  (df range [{df_t.min():.2f}, {df_t.max():.2f}])")
    print(f"constraint-side flips at the {MARGIN:.2f} m bound: {flips * 100:.2f}%")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alt", default="135x240", help="alternate resolution HxW")
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return run(tuple(int(v) for v in args.alt.split("x")), args.scenes, args.device)


if __name__ == "__main__":
    main()
