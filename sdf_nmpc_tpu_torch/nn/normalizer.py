"""Input normalizer statistics, computed once before training and stored
beside the parameters.  Counterpart of sdf_nmpc_tpu/nn/normalizer.py."""

from __future__ import annotations

from typing import NamedTuple

import torch


class NormalizerStats(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor


def compute_stats(data) -> NormalizerStats:
    """Per-feature mean and (biased) standard deviation over axis 0."""
    data = torch.as_tensor(data)
    return NormalizerStats(mean=data.mean(0), std=data.std(0, correction=0))


def normalize(x, stats: NormalizerStats, eps: float = 1e-6):
    return (x - stats.mean) / (stats.std + eps)
