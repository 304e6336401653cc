"""VAE runtime: image -> preprocessing -> encoder -> latent (and decode for
visualization).

Counterpart of sdf_nmpc_tpu/perception/vae_runtime.py: ``set_img`` runs the
preprocessing pipeline on the device, ``encode`` returns the latent mean as
a (1, L) numpy array (what crosses the robot / operator-PC network in the
reference deployment), ``set_latent`` / ``decode`` reconstruct the image.
It takes the port's ``Encoder`` (and optionally ``Decoder``) modules, where
the JAX runtime takes flax variables; both run in eval mode on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .preprocessing import make_image_pipeline


class VaeRuntime:
    def __init__(self, cfg, encoder, decoder=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.encoder = encoder.eval().to(self.device)
        self.decoder = None if decoder is None else decoder.eval().to(self.device)
        self._dtype = next(self.encoder.parameters()).dtype
        self._preprocess = make_image_pipeline(cfg, device=self.device)
        self.img = None
        self.latent = None
        self.decoded = None

    def set_img(self, img):
        self.img = self._preprocess(img)

    def set_latent(self, latent):
        self.latent = torch.as_tensor(np.asarray(latent), dtype=self._dtype,
                                      device=self.device).reshape(1, -1)

    @torch.no_grad()
    def encode(self) -> np.ndarray:
        self.latent = self.encoder(self.img.to(self._dtype))
        return self.latent.cpu().numpy()

    @torch.no_grad()
    def decode(self) -> np.ndarray:
        if self.decoder is None:
            raise RuntimeError("decoder weights not loaded")
        H, W = self.cfg.sensor.shape_imgs[-2:]
        self.decoded = self.decoder(self.latent).reshape(H, W)
        return self.decoded.cpu().numpy()
