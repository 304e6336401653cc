"""beta-VAE training (reference scripts/neural_nets/vae_train.py; the port's
counterpart of scripts/train_vae.py), on the card unless --device cpu:

    python -m sdf_nmpc_tpu_torch.cli.train_vae --data data.h5 --out runs/vae
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--data", required=True, help="hdf5 dataset file")
    ap.add_argument("--out", required=True, help="output run directory")
    ap.add_argument("--dmax", type=float, default=5.0)
    ap.add_argument("--size-latent", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--restart-from-epoch", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..data.h5 import train_dataset_from_h5
    from ..training import VaeTrainConfig, train_vae

    (train_ds, valid_ds), metadata = train_dataset_from_h5(
        args.data_dir, args.data, args.dmax, train_valid_ratio=0.9, vae=True, col_map=True,
        device=args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = VaeTrainConfig(size_latent=args.size_latent, nb_epochs=args.epochs,
                         batch_size=args.batch_size)
    _, history = train_vae(train_ds, valid_ds, metadata, out, cfg=cfg,
                           restart_from_epoch=args.restart_from_epoch, device=args.device)
    (out / "history.json").write_text(json.dumps(history))


if __name__ == "__main__":
    main()
