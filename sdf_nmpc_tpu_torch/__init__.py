"""PyTorch/CUDA port of sdf_nmpc_tpu: the batched neural-SDF SQP-RTI step.

Entry points take ``device=`` and default to ``"cuda"``.  On a machine with no
CUDA device a call that did not ask for the CPU raises; it never carries on
on the CPU.  On the CPU every kernel wrapper runs its plain PyTorch version;
on a CUDA tensor it launches its hand-written kernel or raises.

``Nmpc``, ``build_ocp``, ``default_config`` and ``load_config`` are exported
here lazily (importing the package costs the import of torch alone), and
``cache_dir()`` is the user cache the two packages share.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

_LAZY = {"Nmpc": "controller", "build_ocp": "ocp", "default_config": "config",
         "load_config": "config"}


def __getattr__(name):
    """Lazy convenience re-exports (keeps ``import sdf_nmpc_tpu_torch`` light)."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def cache_dir() -> Path:
    """The user cache directory: ``$SDF_NMPC_TPU_CACHE``, else
    ``~/.cache/sdf_nmpc_tpu``, created if absent.  The JAX package uses the
    same directory, so fitted artifacts (``braking_dist/<cfg.name>/``) are
    shared between the two."""
    d = Path(os.environ.get("SDF_NMPC_TPU_CACHE", Path.home() / ".cache" / "sdf_nmpc_tpu"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def resolve_device(device="cuda") -> torch.device:
    """torch.device for an entry point's ``device=`` argument.

    A CUDA device must exist (no silent CPU fallback).  Selecting CUDA pins
    every float32 product to exact IEEE f32: TF32 is switched off for matmul
    and cuDNN."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        require_exact_f32()
        if dev.index is None:  # tensors report cuda:<index>; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def require_exact_f32():
    """Turn TF32 off for matmul and cuDNN and check that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled")
