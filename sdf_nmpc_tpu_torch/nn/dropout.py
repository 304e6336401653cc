"""Dropout with flax's semantics and explicit random draws.

flax's ``nn.Dropout`` keeps each element with probability 1 - rate and
scales what it keeps by 1 / (1 - rate): ``where(keep, x / keep_prob, 0)``.
Here the keep mask is ``rand < keep_prob`` from a ``torch.Generator`` (the
module's ``generator``, set by ``set_dropout_generator``), so a training run
is reproducible from its seed.  Identity in eval mode and at rate 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dropout(x, rate: float, generator: Optional[torch.Generator] = None, shape=None):
    """flax dropout of ``x``: the keep mask of ``shape`` (default x's; a
    shape with 1s broadcasts one mask along those axes) from ``generator``."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    mask = torch.rand(tuple(x.shape) if shape is None else tuple(shape), generator=generator,
                      dtype=x.dtype, device=x.device) < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """``dropout`` as a module: active in training mode, masks drawn from
    ``self.generator`` (None: torch's default generator)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        return dropout(x, self.rate, self.generator) if self.training else x


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]):
    """Every ``Dropout`` in ``module`` draws its masks from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return module
