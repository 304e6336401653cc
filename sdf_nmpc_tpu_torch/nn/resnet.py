"""Residual conv blocks of the perception VAE, NCHW.

Counterpart of sdf_nmpc_tpu/nn/resnet.py: standard (3x3, 3x3) or bottleneck
(1x1, 3x3, 1x1) blocks; ``stride`` doubles (``ResBlock``) or halves
(``ResBlockDeconv``) the channel count and down/up-samples space; the
shortcut is a strided 1x1 (de)convolution when stride != 1; optional batch
norm (the convolutions then have no bias; ``BatchNorm`` is flax's: epsilon
1e-5, and in training mode the running statistics move by 0.01 toward the
batch's mean and **biased** variance, where torch's own moves by 0.1 toward
the unbiased one) and terminal dropout (``dropout.Dropout``, flax's).  The
sub-modules carry the flax names (``Conv_0``, ``BatchNorm_1``,
``ConvTransposeTorch_2``, ...), numbered in the order flax creates them, so
``weights.encoder_from_jax`` and ``decoder_from_jax`` carry a flax tree
across by name.

flax's 1x1 strided convolution pads 'SAME', which for a 1x1 kernel is no
padding at every size, odd or even: torch's padding 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout

BN_EPS = 1e-5
BN_MOMENTUM = 0.99  # flax's: running = 0.99 running + (1 - 0.99) batch


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` over NCHW channels.  Eval mode is
    ``nn.BatchNorm2d``'s (the running statistics).  Training mode
    normalizes with the batch's mean and biased variance, as both do, and
    updates the running statistics as flax does: ``r = 0.99 r + (1 - 0.99)
    b`` with the biased batch variance (torch's own: momentum 0.1, the
    unbiased variance)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
            self.num_batches_tracked.add_(1)
        return y


def init_from(module: nn.Module, generator: Optional[torch.Generator]):
    """Redraw every convolution and linear layer of ``module`` from
    ``generator``: weights and biases uniform in +-1/sqrt(fan_in), torch's
    default bound; BatchNorm scale 1, bias 0.  No-op without a generator."""
    if generator is None:
        return module
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = m.weight[0].numel() if not isinstance(m, nn.ConvTranspose2d) else (
                    m.weight.shape[1] * m.weight[0, 0].numel())
                b = 1.0 / np.sqrt(fan_in)
                m.weight.uniform_(-b, b, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-b, b, generator=generator)
    return module


def ConvTransposeTorch(size_in: int, features: int, kernel_size: int, stride: int = 1,
                       padding: int = 0, output_padding: int = 0,
                       use_bias: bool = True) -> nn.ConvTranspose2d:
    """torch's own transposed convolution, which the JAX package's
    ``ConvTransposeTorch`` reproduces with a dilated cross-correlation."""
    return nn.ConvTranspose2d(size_in, features, kernel_size, stride=stride, padding=padding,
                              output_padding=output_padding, bias=use_bias)


class _Block(nn.Module):
    """What ResBlock and ResBlockDeconv share: the BatchNorms, the terminal
    ReLU over main path + shortcut, and dropout."""

    def __init__(self, use_batchnorm: bool, dropout_rate: float):
        super().__init__()
        self.use_batchnorm = bool(use_batchnorm)
        self.dropout = Dropout(dropout_rate) if dropout_rate else None
        self._n_bn = 0

    def _bn(self, channels: int):
        """The next BatchNorm_i (flax numbers them in call order), or None."""
        if not self.use_batchnorm:
            return None
        bn = BatchNorm(channels)
        setattr(self, f"BatchNorm_{self._n_bn}", bn)
        self._n_bn += 1
        return bn

    @staticmethod
    def _norm(bn, h):
        return h if bn is None else bn(h)

    def _forward(self, convs, bns, shortcut, x):
        h = x
        for i, (conv, bn) in enumerate(zip(convs, bns)):
            h = self._norm(bn, conv(h))
            if i < len(convs) - 1:
                h = F.relu(h)
        sc = x if shortcut is None else self._norm(shortcut[1], shortcut[0](x))
        h = F.relu(h + sc)
        return h if self.dropout is None else self.dropout(h)


class ResBlock(_Block):
    def __init__(self, size_in: int, stride: int, bottleneck: bool = False,
                 use_batchnorm: bool = False, dropout_rate: float = 0.0):
        super().__init__(use_batchnorm, dropout_rate)
        size_out, size_inner = size_in * stride, size_in // 4
        bias = not use_batchnorm
        if bottleneck:
            shapes = [(size_in, size_inner, 1, stride, 0), (size_inner, size_inner, 3, 1, 1),
                      (size_inner, size_out, 1, 1, 0)]
        else:
            shapes = [(size_in, size_out, 3, stride, 1), (size_out, size_out, 3, 1, 1)]
        self.n_main = len(shapes)
        self._bns = []
        for i, (cin, cout, k, s, p) in enumerate(shapes):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout, k, stride=s, padding=p, bias=bias))
            self._bns.append(self._bn(cout))
        self.has_shortcut = stride != 1
        if self.has_shortcut:
            setattr(self, f"Conv_{self.n_main}",
                    nn.Conv2d(size_in, size_out, 1, stride=stride, bias=bias))
            self._bns.append(self._bn(size_out))

    def forward(self, x):
        convs = [getattr(self, f"Conv_{i}") for i in range(self.n_main)]
        shortcut = ((getattr(self, f"Conv_{self.n_main}"), self._bns[-1])
                    if self.has_shortcut else None)
        return self._forward(convs, self._bns[:self.n_main], shortcut, x)


class ResBlockDeconv(_Block):
    def __init__(self, size_in: int, stride: int, bottleneck: bool = False,
                 use_batchnorm: bool = False, dropout_rate: float = 0.0,
                 output_padding: int = 0):
        super().__init__(use_batchnorm, dropout_rate)
        size_out, size_inner = size_in // stride, size_in // 4
        bias, op = not use_batchnorm, output_padding
        if bottleneck:
            shapes = [(size_in, size_inner, 1, stride, 0, op), (size_inner, size_inner, 3, 1, 1, 0),
                      (size_inner, size_out, 1, 1, 0, 0)]
        else:
            shapes = [(size_in, size_out, 3, stride, 1, op), (size_out, size_out, 3, 1, 1, 0)]
        self.n_main = len(shapes)
        self._bns = []
        for i, (cin, cout, k, s, p, o) in enumerate(shapes):
            setattr(self, f"ConvTransposeTorch_{i}",
                    ConvTransposeTorch(cin, cout, k, s, p, o, use_bias=bias))
            self._bns.append(self._bn(cout))
        self.has_shortcut = stride != 1
        if self.has_shortcut:
            setattr(self, f"ConvTransposeTorch_{self.n_main}",
                    ConvTransposeTorch(size_in, size_out, 1, stride, 0, op, use_bias=bias))
            # the reference's deconv shortcut always applies BatchNorm; kept
            # only when batchnorm is on, as the JAX package keeps it
            self._bns.append(self._bn(size_out))

    def forward(self, x):
        convs = [getattr(self, f"ConvTransposeTorch_{i}") for i in range(self.n_main)]
        shortcut = ((getattr(self, f"ConvTransposeTorch_{self.n_main}"), self._bns[-1])
                    if self.has_shortcut else None)
        return self._forward(convs, self._bns[:self.n_main], shortcut, x)
