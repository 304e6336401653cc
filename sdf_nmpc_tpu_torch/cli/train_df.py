"""SDF-network training against a frozen VAE encoder (reference
scripts/neural_nets/df_train.py; the port's counterpart of
scripts/train_df.py), on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.train_df --data data.h5 --encoder runs/vae \\
        --out runs/sdf

--encoder is a train_vae run directory, the port's (weights.pt) or the JAX
package's (weights.msgpack).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=".", help="directory holding the dataset")
    ap.add_argument("--data", required=True, help="hdf5 dataset file")
    ap.add_argument("--encoder", required=True, help="train_vae run directory")
    ap.add_argument("--out", required=True, help="output run directory")
    ap.add_argument("--dmax", type=float, default=5.0)
    ap.add_argument("--size-latent", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--points-per-img", type=int, default=2500)
    ap.add_argument("--restart-from-epoch", type=int, default=0)
    ap.add_argument("--variants", default="128_128_128_128,256_256_128_64",
                    help="comma-separated layer-size variants (the reference trains two)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..data.h5 import train_dataset_from_h5
    from ..training import DfTrainConfig, load_encoder_from_vae_ckpt, train_df

    (train_ds, valid_ds), metadata = train_dataset_from_h5(
        args.data_dir, args.data, args.dmax, train_valid_ratio=0.9, vae=False,
        device=args.device)
    encoder = load_encoder_from_vae_ckpt(args.encoder, args.size_latent, device=args.device)
    cfg = DfTrainConfig(dmax=args.dmax, nb_epochs=args.epochs, batch_size=args.batch_size,
                        points_per_img=args.points_per_img)
    for variant in args.variants.split(","):
        sizes = [int(v) for v in variant.split("_")]
        out = Path(args.out) / variant
        out.mkdir(parents=True, exist_ok=True)
        print(f"=== training variant {variant} ===")
        _, history = train_df(train_ds, valid_ds, metadata, encoder, out, cfg=cfg,
                              nn_kwargs={"layer_sizes": sizes}, size_latent=args.size_latent,
                              restart_from_epoch=args.restart_from_epoch, device=args.device)
        (out / "history.json").write_text(json.dumps(history))


if __name__ == "__main__":
    main()
