"""Merge several HDF5 image sets into one train / test dataset (reference
scripts/neural_nets/create_h5.py; the port's counterpart of
scripts/create_h5.py):

    python -m sdf_nmpc_tpu_torch.cli.create_h5 a.h5 b.h5 --out merged.h5
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", help="input hdf5 files")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ratio-test", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..data.h5 import merge_h5

    out = merge_h5(args.sources, args.out, ratio_test=args.ratio_test, seed=args.seed)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
