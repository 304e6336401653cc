"""Training metrics writers.

Counterpart of sdf_nmpc_tpu/training/metrics.py: per-loss scalars (the
reference's TensorBoard tags, df_train.py:127-128, 196-236) as JSON lines
always, and to TensorBoard when it imports.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path


def no_timer(name):
    """The default ``timer`` of the training loops: times nothing."""
    return contextlib.nullcontext()


class MetricsWriter:
    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=str(self.log_dir))

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, scalars: dict, step: int):
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def df_loss_scalars(parts) -> dict:
    """The reference's tag layout (df_train.py:196-201)."""
    return {
        "loss/regression": parts[0],
        "loss/gradient": parts[1],
        "loss/gradient_dir": parts[2],
        "loss/eikonal": parts[3],
        "loss/total": sum(parts),
    }
