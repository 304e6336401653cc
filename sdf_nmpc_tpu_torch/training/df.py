"""SDF-network training loop on ``torch.optim.AdamW``.

Counterpart of sdf_nmpc_tpu/training/df.py (reference
scripts/neural_nets/df_train.py): the frozen VAE encoder gives M sampled
latents per image (:163-166); the training points mix the frustum, a ball,
the obstacles' surroundings and the frustum's margin (:22-37, ratios
:62-64); the ground-truth SDF and gradients come from the data engine
(:168); the composite SDF loss (regression / gradient / direction /
eikonal) is weighted (50, 0, 1/60, 5) (:73); AdamW with an epoch-wise
cosine learning rate that stops after lr_nb_steps (:137-148, :245-247);
per-epoch checkpoints and resume.

Dropout (0.1 by default) follows the JAX package's structure: the value
path draws one mask per point and layer, the input gradient's second
forward one (1, width) mask per layer shared by every point
(``loss_sdf``'s ``grad_apply_fn``; ROADMAP §3, bug-compatible on purpose).
Random draws come from one ``torch.Generator`` on the device, seeded by
``cfg.seed``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.df_computer import DfComputer
from ..data.losses import loss_sdf
from ..data.pos_sampler import PosSampler
from ..nn.neural_df import NeuralDF
from ..nn.vae import sample_latent
from .checkpoints import load_checkpoint, save_checkpoint
from .metrics import MetricsWriter, df_loss_scalars, no_timer


@dataclasses.dataclass
class DfTrainConfig:
    max_df: float = 1.0
    dmax: float = 5.0
    signed: bool = True
    nb_epochs: int = 200
    lr_start: float = 5e-5
    lr_min: float = 1e-5
    lr_nb_steps: int = 20
    weight_decay: float = 1e-5
    batch_size: int = 50
    points_per_img: int = 2500
    ratio_points_ball: float = 0.2
    ratio_points_obs: float = 0.4
    ratio_points_margin: float = 0.15
    close_ball_size: float = 0.75
    loss_weights: Sequence[float] = (50.0, 0.0, 1 / 60, 5.0)
    seed: int = 0

    def point_counts(self):
        n = self.points_per_img
        nb_ball = int(n * self.ratio_points_ball)
        nb_obs = int(n * self.ratio_points_obs)
        nb_margin = int(n * self.ratio_points_margin)
        nb_frustum = n - nb_ball - nb_obs - nb_margin
        return nb_frustum, nb_ball, nb_obs, nb_margin

    def lr_at_epoch(self, epoch: int) -> float:
        """Cosine annealing, frozen after lr_nb_steps (the reference's)."""
        t = min(epoch, self.lr_nb_steps)
        return self.lr_min + 0.5 * (self.lr_start - self.lr_min) * (
            1 + np.cos(np.pi * t / self.lr_nb_steps))


def sample_points(generator, sampler: PosSampler, imgs, counts, ball_size):
    """Mixed-region points (B * n, 3), grouped per image (reference
    df_train.py:22-37)."""
    nb_f, nb_b, nb_o, nb_m = counts
    B = imgs.shape[0]
    states_f = sampler.sample_pos_in_frustrum(generator, B * nb_f).reshape(B, nb_f, 3)
    states_b = sampler.sample_pos_in_ball(generator, B * nb_b, ball_size).reshape(B, nb_b, 3)
    states_m = sampler.sample_pos_in_frustrum_margin(generator, B * nb_m).reshape(B, nb_m, 3)
    states_o = sampler.sample_pos_around_obs(generator, imgs, nb_o, mode="random", std=0.1)
    return torch.cat([states_f, states_b, states_o, states_m], dim=1).reshape(-1, 3)


@torch.no_grad()
def encode_latents(encoder, imgs_in, num_samples: int, generator=None, train: bool = True):
    """The frozen encoder's latents, one per sampled point: M samples of
    each image's posterior (training), or its mean repeated M times."""
    if train:
        mean, logvar = encoder(imgs_in, with_logvar=True)
        return sample_latent(mean, logvar, num_samples, generator=generator)
    return encoder(imgs_in).repeat_interleave(num_samples, dim=0)


def df_loss(net: NeuralDF, states, latents, df_gt, df_grads, weights, generator=None):
    """(weighted total, the four parts (4,)) of ``loss_sdf`` on the points.
    In training mode with dropout the input gradient takes its own forward
    with shared masks; under ``torch.no_grad`` the input gradient is taken
    without a graph."""
    inputs = torch.cat([states, latents], dim=-1)
    if net.training and net.dropout_rate > 0:
        apply_fn = lambda x: net(x, generator)
        grad_fn = lambda x: net(x, generator, shared_mask=True)
    else:
        apply_fn, grad_fn = net, None
    losses = loss_sdf(apply_fn, inputs, df_grads, df_gt, grad_fn,
                      create_graph=torch.is_grad_enabled())
    total = sum(w * l for w, l in zip(weights, losses))
    return total, torch.stack(losses)


def df_train_step(net, optimizer, states, latents, df_gt, df_grads, weights, lr,
                  generator=None, timer=no_timer):
    """One AdamW step at learning rate ``lr``; the loss parts (4,)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    with timer("loss"):  # forward, input gradient, double backward
        optimizer.zero_grad(set_to_none=True)
        total, parts = df_loss(net, states, latents, df_gt, df_grads, weights, generator)
        total.backward()
    with timer("update"):
        optimizer.step()
    return parts.detach()


def train_df(train_ds, valid_ds, metadata, encoder, out_dir, cfg: DfTrainConfig = DfTrainConfig(),
             nn_kwargs: Optional[dict] = None, size_latent: int = 128,
             restart_from_epoch: int = 0, log_fn=print, device="cuda", timer=no_timer):
    """Train one NeuralDF variant against the frozen ``encoder``.  Returns
    (the network in eval mode, history).  ``timer(name)``: a context
    manager around each part of a training step (encode, sampling, gt,
    loss, update)."""
    dev = resolve_device(device)
    kwargs = dict(signed=cfg.signed, size_latent=size_latent, nb_freqs=5, res="full",
                  embed="oct", act="sin", dropout_rate=0.1, w0=20.0)
    kwargs.update(nn_kwargs or {})  # the caller's values win (w0 etc.)
    net = NeuralDF(**kwargs, generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    encoder = encoder.to(dev).eval()
    df_cpt = DfComputer(cfg.signed, cfg.dmax, metadata["hfov"], metadata["vfov"], cfg.max_df,
                        is_depth=metadata["is_depth"], is_spherical=metadata["is_spherical"],
                        device=dev)
    sampler = PosSampler(cfg.dmax, metadata["hfov"], metadata["vfov"], margin=40,
                         is_spherical=metadata["is_spherical"], device=dev)
    # torch's AdamW decays by 1e-2 unless told: pass the config's
    optimizer = torch.optim.AdamW(net.parameters(), lr=cfg.lr_start,
                                  weight_decay=cfg.weight_decay)
    if restart_from_epoch:
        load_checkpoint(out_dir, net, optimizer, epoch=restart_from_epoch - 1)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    counts = cfg.point_counts()
    weights = tuple(cfg.loss_weights)

    def batch(imgs_in, imgs_out, train):
        with timer("encode"):
            latents = encode_latents(encoder, imgs_in, cfg.points_per_img, generator, train)
        with timer("sampling"):
            states = sample_points(generator, sampler, imgs_out[:, 0], counts,
                                   cfg.close_ball_size)
        with timer("gt"):
            df_gt, df_grads = df_cpt.get_df(imgs_out[:, 0], states)
        return states, latents, df_gt, df_grads

    tsb_train = MetricsWriter(Path(out_dir) / "train")
    tsb_valid = MetricsWriter(Path(out_dir) / "valid")
    history = []
    for epoch in range(restart_from_epoch, cfg.nb_epochs):
        tic = time.time()
        lr = float(cfg.lr_at_epoch(epoch))
        net.train()
        agg_train = torch.zeros(4, device=dev)
        n_batches = 0
        for imgs_in, imgs_out in train_ds.batches(cfg.batch_size, generator, shuffle=True):
            agg_train += df_train_step(net, optimizer, *batch(imgs_in, imgs_out, True), weights,
                                       lr, generator, timer)
            n_batches += 1
        agg_train = (agg_train / max(n_batches, 1)).cpu().numpy()

        agg_valid = np.zeros(4)
        n_valid = 0
        if valid_ds is not None:
            net.eval()
            acc = torch.zeros(4, device=dev)
            with torch.no_grad():
                for imgs_in, imgs_out in valid_ds.batches(cfg.batch_size):
                    acc += df_loss(net, *batch(imgs_in, imgs_out, False), weights)[1]
                    n_valid += 1
            agg_valid = (acc / max(n_valid, 1)).cpu().numpy()

        tsb_train.add_scalars(df_loss_scalars(agg_train), epoch)
        if n_valid:
            tsb_valid.add_scalars(df_loss_scalars(agg_valid), epoch)
        save_checkpoint(out_dir, net, optimizer, epoch, extra={"lr": lr})
        rec = {"epoch": epoch, "lr": lr, "time": time.time() - tic,
               "train": agg_train.tolist(), "valid": agg_valid.tolist()}
        history.append(rec)
        log_fn(f"epoch {epoch} lr {lr:.2e} train {agg_train.round(4).tolist()} "
               f"valid {agg_valid.round(4).tolist()} ({rec['time']:.1f}s)")
    tsb_train.close()
    tsb_valid.close()
    return net.eval(), history
