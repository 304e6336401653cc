"""The stability terminal-cost constant r-tilde (counterpart of
scripts/find_rtilde.py), on the card unless ``--device cpu``:

    python -m sdf_nmpc_tpu_torch.cli.find_rtilde [default | CONFIG.yaml] [--device cpu]
"""

from __future__ import annotations

import argparse


def load_cfg(config: str):
    """The default config, or a YAML config file (PyYAML needed)."""
    from ..config import default_config, load_config

    return default_config() if config == "default" else load_config(config)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="default", help="config yaml path or 'default'")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..theory import get_r_tilde_max

    r = get_r_tilde_max(load_cfg(args.config), device=args.device)
    print(f"r_tilde_max = {r:.6f}")
    return r


if __name__ == "__main__":
    main()
