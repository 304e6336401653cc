"""PyTorch/CUDA port of sdf_nmpc_tpu: the batched neural-SDF SQP-RTI step.

Entry points take ``device=`` and default to ``"cuda"``.  On a machine with no
CUDA device a call that did not ask for the CPU raises; it never carries on
on the CPU.  On the CPU every kernel wrapper runs its plain PyTorch version;
on a CUDA tensor it launches its hand-written kernel or raises.
"""

from __future__ import annotations

import torch


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
