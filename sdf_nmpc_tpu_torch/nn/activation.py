"""Activations."""

from __future__ import annotations

import torch


def sine(x, w0: float = 30.0):
    """SIREN sine activation [Sitzmann et al., 2020], default frequency 30."""
    return torch.sin(w0 * x)
