"""Command-line entry points: ``python -m sdf_nmpc_tpu_torch.cli.<name>``."""
