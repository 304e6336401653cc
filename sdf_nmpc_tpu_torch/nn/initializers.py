"""Weight initializers (reference sdf_nmpc/utils/layer_init.py).

Counterpart of sdf_nmpc_tpu/nn/initializers.py.  ``apply_conv_init`` is the
reference's ``init_conv_layers``: xavier-uniform with the 'conv2d' gain (1)
on every convolution and transposed-convolution weight, zero biases; linear
layers untouched.  The bound sqrt(6 / (fan_in + fan_out)) is symmetric in
the two fans, so torch's (in, out, kh, kw) transposed-weight layout draws
from the same bound as flax's (kh, kw, in, out).  (The SIREN init lives in
``NeuralDF.reset_parameters``.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


@torch.no_grad()
def apply_conv_init(module: nn.Module, generator: Optional[torch.Generator] = None):
    """Xavier-uniform convolution weights and zero biases, drawn from
    ``generator``, in place; returns the module."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_uniform_(m.weight, gain=nn.init.calculate_gain("conv2d"),
                                    generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return module
