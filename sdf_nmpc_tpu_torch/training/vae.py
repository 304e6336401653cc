"""beta-VAE training loop on ``torch.optim.AdamW``.

Counterpart of sdf_nmpc_tpu/training/vae.py (reference
scripts/neural_nets/vae_train.py): encoder mean / logvar -> a
reparameterized sample -> decoder; the reconstruction loss is the masked
MSE with the positive and distance bias (pos ratio 0.1, dist ratio 0.1,
degree 3, vae_train.py:44-47, :112) plus the beta-normalized KLD; AdamW
with an epoch-wise cosine learning rate; per-epoch checkpoints and resume.

The convolutions start xavier-uniform with zero biases (``apply_conv_init``;
the linear layers keep torch's default init, the reference's).  BatchNorm
trains as flax's (``nn/resnet.py::BatchNorm``): a training step updates
the running statistics of the encoder's and the decoder's layers both, as
the JAX package's ``train_step`` keeps them.  Dropout and the latent
samples draw from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.losses import loss_kld, loss_mse_valid_pixels, loss_mse_valid_pixels_bias_pos_dist
from ..nn.dropout import set_dropout_generator
from ..nn.initializers import apply_conv_init
from ..nn.vae import Vae, sample_latent
from .checkpoints import load_checkpoint, save_checkpoint
from .metrics import MetricsWriter, no_timer


@dataclasses.dataclass
class VaeTrainConfig:
    size_latent: int = 128
    nb_epochs: int = 100
    lr_start: float = 1e-4
    lr_min: float = 1e-5
    lr_nb_steps: int = 20
    weight_decay: float = 1e-5
    batch_size: int = 16
    beta_kld: float = 1.0
    bias: bool = True
    bias_dist_ratio: float = 0.1
    bias_dist_degree: int = 3
    bias_pos_ratio: float = 0.1
    dropout_rate: float = 0.1
    batchnorm: bool = True
    seed: int = 0

    def lr_at_epoch(self, epoch: int) -> float:
        t = min(epoch, self.lr_nb_steps)
        return self.lr_min + 0.5 * (self.lr_start - self.lr_min) * (
            1 + np.cos(np.pi * t / self.lr_nb_steps))


def recon_loss(cfg: VaeTrainConfig, target, pred):
    if cfg.bias:
        return loss_mse_valid_pixels_bias_pos_dist(target, pred, cfg.bias_pos_ratio,
                                                   cfg.bias_dist_ratio, cfg.bias_dist_degree)
    return loss_mse_valid_pixels(target, pred)


def vae_losses(vae: Vae, imgs_in, imgs_out, cfg: VaeTrainConfig, generator=None, eps=None):
    """(total, reconstruction, KLD) of one training forward: the latent
    sampled (``eps`` standard normal, else drawn from ``generator``)."""
    mean, logvar = vae.encoder(imgs_in, with_logvar=True)
    recon = vae.decoder(sample_latent(mean, logvar, generator=generator, eps=eps))
    l_reg = recon_loss(cfg, imgs_out, recon)
    l_kld = loss_kld(mean, logvar, cfg.beta_kld, cfg.size_latent, vae.decoder.shape_imgs[-2:])
    return l_reg + l_kld, l_reg, l_kld


def vae_train_step(vae, optimizer, imgs_in, imgs_out, cfg, lr, generator=None, eps=None):
    """One AdamW step at learning rate ``lr`` in training mode (batch
    statistics, dropout); (reconstruction, KLD) detached."""
    vae.train()
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    optimizer.zero_grad(set_to_none=True)
    total, l_reg, l_kld = vae_losses(vae, imgs_in, imgs_out, cfg, generator, eps)
    total.backward()
    optimizer.step()
    return l_reg.detach(), l_kld.detach()


@torch.no_grad()
def vae_eval_losses(vae, imgs_in, imgs_out, cfg):
    """(reconstruction, KLD) in eval mode, the latent mean decoded."""
    vae.eval()
    mean, logvar = vae.encoder(imgs_in, with_logvar=True)
    return (recon_loss(cfg, imgs_out, vae.decoder(mean)),
            loss_kld(mean, logvar, cfg.beta_kld, cfg.size_latent, vae.decoder.shape_imgs[-2:]))


def train_vae(train_ds, valid_ds, metadata, out_dir, cfg: VaeTrainConfig = VaeTrainConfig(),
              restart_from_epoch: int = 0, log_fn=print, device="cuda",
              timer=no_timer):
    """Returns (the Vae in eval mode, history).  ``timer(name)``: a context
    manager around each training step ('step')."""
    dev = resolve_device(device)
    H, W = metadata["shape_imgs"][-2], metadata["shape_imgs"][-1]
    init = torch.Generator().manual_seed(cfg.seed)
    vae = Vae(size_latent=cfg.size_latent, shape_imgs=(1, H, W), dropout_rate=cfg.dropout_rate,
              batchnorm=cfg.batchnorm, generator=init)
    apply_conv_init(vae, init)  # xavier convolutions (layer_init.py:5-12)
    vae = vae.to(dev)
    # torch's AdamW decays by 1e-2 unless told: pass the config's
    optimizer = torch.optim.AdamW(vae.parameters(), lr=cfg.lr_start,
                                  weight_decay=cfg.weight_decay)
    if restart_from_epoch:
        load_checkpoint(out_dir, vae, optimizer, epoch=restart_from_epoch - 1)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    set_dropout_generator(vae, generator)

    tsb_train = MetricsWriter(Path(out_dir) / "train")
    tsb_valid = MetricsWriter(Path(out_dir) / "valid")
    history = []
    for epoch in range(restart_from_epoch, cfg.nb_epochs):
        tic = time.time()
        lr = float(cfg.lr_at_epoch(epoch))
        agg_t, nb_t = torch.zeros(2, device=dev), 0
        for imgs_in, imgs_out in train_ds.batches(cfg.batch_size, generator, shuffle=True):
            with timer("step"):
                parts = vae_train_step(vae, optimizer, imgs_in, imgs_out, cfg, lr, generator)
            agg_t += torch.stack(parts)
            nb_t += 1
        agg_t = (agg_t / max(nb_t, 1)).cpu().numpy()

        agg_v, nb_v = np.zeros(2), 0
        if valid_ds is not None:
            acc = torch.zeros(2, device=dev)
            for imgs_in, imgs_out in valid_ds.batches(cfg.batch_size):
                acc += torch.stack(vae_eval_losses(vae, imgs_in, imgs_out, cfg))
                nb_v += 1
            agg_v = (acc / max(nb_v, 1)).cpu().numpy()

        tsb_train.add_scalars({"loss/regression": agg_t[0], "loss/kld": agg_t[1]}, epoch)
        if nb_v:
            tsb_valid.add_scalars({"loss/regression": agg_v[0], "loss/kld": agg_v[1]}, epoch)
        save_checkpoint(out_dir, vae, optimizer, epoch, extra={"lr": lr})
        rec = {"epoch": epoch, "lr": lr, "time": time.time() - tic,
               "train": agg_t.tolist(), "valid": agg_v.tolist()}
        history.append(rec)
        log_fn(f"epoch {epoch} lr {lr:.2e} train {agg_t.round(5).tolist()} "
               f"valid {agg_v.round(5).tolist()} ({rec['time']:.1f}s)")
    tsb_train.close()
    tsb_valid.close()
    return set_dropout_generator(vae, None).eval(), history
