"""Range-image VAE: a ResNet encoder to a latent, a deconvolution decoder
back to the image.  NCHW; images are (B, 1, H, W).

Counterpart of sdf_nmpc_tpu/nn/vae.py (NHWC there):
  Encoder: Conv 7x7 s2 -> ELU -> MaxPool 3x3 s2 -> ResBlock(64, s2) ->
           ResBlock(128, s2) -> ResBlock(256, s2) -> ResBlock(512, s1) ->
           AdaptiveAvgPool(2, 2) -> Dropout -> Flatten -> mean / logvar heads
  Decoder: Linear(512*8*15) -> ELU -> unflatten -> Dropout ->
           4x ResBlockDeconv(s2) -> ConvTranspose 5x5 s1 -> bilinear resize
           (antialiased when it shrinks) -> sigmoid
  Vae:     in training mode the latent is sampled; in eval mode it is the mean.

The heads flatten (C, H, W) and the decoder unflattens (C, H, W), torch's
order; the JAX modules flatten (H, W, C), and ``weights.encoder_from_jax``
/ ``decoder_from_jax`` permute the head rows across.  Layers carry the flax
names (``Conv_0``, ``ResBlock_i``, ``mean``, ``logvar``, ``Dense_0``,
``ResBlockDeconv_i``, ``ConvTransposeTorch_0``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.timing import span
from .dropout import Dropout
from .resnet import ConvTransposeTorch, ResBlock, ResBlockDeconv, init_from

ENC_CHANNELS = (64, 128, 256, 512)
ENC_STRIDES = (2, 2, 2, 1)
DEC_CHANNELS = (512, 256, 128, 64)


def adaptive_avg_pool2d(x, out_hw=(2, 2)):
    """torch.nn.AdaptiveAvgPool2d: region i spans [floor(i*S/O),
    ceil((i+1)*S/O)), so regions may overlap.  (..., C, H, W)."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


class Encoder(nn.Module):
    def __init__(self, nb_chan: int = 1, size_latent: int = 128, dropout_rate: float = 0.1,
                 batchnorm: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size_latent = size_latent
        self.Conv_0 = nn.Conv2d(nb_chan, 64, 7, stride=2, padding=3)
        for i, (ch, stride) in enumerate(zip(ENC_CHANNELS, ENC_STRIDES)):
            # the last, stride-1 block has no dropout
            setattr(self, f"ResBlock_{i}", ResBlock(
                ch, stride, use_batchnorm=batchnorm,
                dropout_rate=dropout_rate if stride != 1 else 0.0))
        self.dropout = Dropout(dropout_rate) if dropout_rate else None
        feats = ENC_CHANNELS[-1] * ENC_STRIDES[-1] * 4  # a 2 x 2 pooled map
        self.mean = nn.Linear(feats, size_latent)
        self.logvar = nn.Linear(feats, size_latent)
        init_from(self, generator)

    def features(self, x):
        x = F.elu(self.Conv_0(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as flax's
        for i in range(len(ENC_CHANNELS)):
            x = getattr(self, f"ResBlock_{i}")(x)
        x = adaptive_avg_pool2d(x, (2, 2))
        if self.dropout is not None:
            x = self.dropout(x)
        return x.flatten(1)

    def forward(self, x, with_logvar: bool = False):
        """x: (B, 1, H, W).  The latent mean, or (mean, logvar) (the profiler
        span ``nmpc.perception.encoder``)."""
        with span("nmpc.perception.encoder"):
            feats = self.features(x)
            mean = self.mean(feats)
            return (mean, self.logvar(feats)) if with_logvar else mean


def sample_latent(mean, logvar, num_samples: int = 1,
                  generator: Optional[torch.Generator] = None, eps=None):
    """Reparameterized latent samples: eps * exp(logvar / 2) + mean, eps
    standard normal from ``generator`` unless given ((B, L), or (B, M, L)
    for M > 1).  For M > 1 the result is (B*M, L), each image's samples
    contiguous."""
    B, L = mean.shape
    shape = (B, L) if num_samples == 1 else (B, num_samples, L)
    if eps is None:
        eps = torch.randn(shape, generator=generator, dtype=mean.dtype, device=mean.device)
    if num_samples == 1:
        return eps * torch.exp(0.5 * logvar) + mean
    lat = eps * torch.exp(0.5 * logvar)[:, None, :] + mean[:, None, :]
    return lat.reshape(B * num_samples, L)


class Decoder(nn.Module):
    def __init__(self, nb_chan: int = 1, size_latent: int = 128,
                 shape_imgs: Sequence[int] = (1, 270, 480), dropout_rate: float = 0.1,
                 batchnorm: bool = True, unflatten_hw: Sequence[int] = (8, 15),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shape_imgs = tuple(int(s) for s in shape_imgs)
        self.unflatten_hw = tuple(int(s) for s in unflatten_hw)
        uh, uw = self.unflatten_hw
        self.Dense_0 = nn.Linear(size_latent, 512 * uh * uw)
        self.dropout = Dropout(dropout_rate) if dropout_rate else None
        for i, ch in enumerate(DEC_CHANNELS):
            setattr(self, f"ResBlockDeconv_{i}", ResBlockDeconv(
                ch, 2, use_batchnorm=batchnorm, dropout_rate=dropout_rate, output_padding=1))
        self.ConvTransposeTorch_0 = ConvTransposeTorch(DEC_CHANNELS[-1] // 2, nb_chan, 5,
                                                       padding=2)
        init_from(self, generator)

    def forward(self, z):
        """z: (B, L) -> (B, nb_chan, H, W)."""
        uh, uw = self.unflatten_hw
        x = F.elu(self.Dense_0(z)).reshape(z.shape[0], 512, uh, uw)
        if self.dropout is not None:
            x = self.dropout(x)
        for i in range(len(DEC_CHANNELS)):
            x = getattr(self, f"ResBlockDeconv_{i}")(x)
        x = self.ConvTransposeTorch_0(x)
        x = F.interpolate(x, size=self.shape_imgs[-2:], mode="bilinear", align_corners=False,
                          antialias=True)
        return torch.sigmoid(x)


class Vae(nn.Module):
    def __init__(self, size_latent: int = 128, shape_imgs: Sequence[int] = (1, 270, 480),
                 dropout_rate: float = 0.1, batchnorm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = Encoder(1, size_latent, dropout_rate, batchnorm, generator=generator)
        self.decoder = Decoder(1, size_latent, shape_imgs, dropout_rate, batchnorm,
                               generator=generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """Eval mode: decode the latent mean.  Training mode: decode a latent
        sampled from ``generator``."""
        if self.training:
            mean, logvar = self.encoder(x, with_logvar=True)
            latent = sample_latent(mean, logvar, generator=generator)
        else:
            latent = self.encoder(x)
        return self.decoder(latent)
