"""Host constants kept on the device, so a step copies none to the card.

``torch.as_tensor(numpy_array, device="cuda")`` inside a step is a
synchronizing copy: it waits for all the work queued on the card before it
returns.  ``kept(a, like)`` makes that copy once per value, dtype and
device and returns the kept tensor on every later call.  The key is the
constant's bytes, shape and numpy dtype, so a constant edited in place is a
new constant, never a stale one.  Kept tensors are plain tensors built
outside inference mode: constants under ``vmap``, ``jacfwd`` and ``jacrev``,
usable by autograd.  Callers never write to them.

``kept_counts`` counts the calls that ``built`` a tensor and those that
``reused`` one, beside ``ops/_lib.py``'s ``launch_counts``: after a step's
first call, a steady step builds nothing.
"""

from __future__ import annotations

import numpy as np
import torch

kept_counts = {"built": 0, "reused": 0}
_kept: dict = {}


def kept(a, like: torch.Tensor, dtype: torch.dtype = None) -> torch.Tensor:
    """``a`` (an array-like of the host) as a tensor on ``like``'s device,
    in ``dtype`` (default ``like``'s), copied to the device on the first
    call alone."""
    a = np.asarray(a)
    dtype = like.dtype if dtype is None else dtype
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, like.device)
    t = _kept.get(key)
    if t is not None:
        kept_counts["reused"] += 1
        return t
    with torch.inference_mode(False):
        t = torch.tensor(a, dtype=dtype, device=like.device)  # a copy, on the CPU too
    _kept[key] = t
    kept_counts["built"] += 1
    return t


def reset_kept_counts():
    for k in kept_counts:
        kept_counts[k] = 0
