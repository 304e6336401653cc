"""Checkpoints of a training run.

Counterpart of sdf_nmpc_tpu/training/checkpoints.py, in the port's own
format under the JAX package's layout: ``weights.pt`` (the latest) and
``epochs/e{i}.pt``, each a ``torch.save`` of the model's state dict (its
BatchNorm running statistics included) and the optimizer's, and
``state.json`` with the epoch counter, so that a resumed run takes the
cosine schedule up where it stopped.  ``load_encoder_from_vae_ckpt`` also
reads a run written by the JAX package (``weights.msgpack``, through the
port's own flax-msgpack reader).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .. import resolve_device


def save_checkpoint(folder, model, optimizer, epoch: int, extra: dict | None = None):
    folder = Path(folder)
    (folder / "epochs").mkdir(parents=True, exist_ok=True)
    blob = {"model": model.state_dict(),
            "optimizer": optimizer.state_dict() if optimizer is not None else None}
    torch.save(blob, folder / "weights.pt")
    torch.save(blob, folder / "epochs" / f"e{epoch}.pt")
    (folder / "state.json").write_text(json.dumps({"epoch": epoch, **(extra or {})}))


def load_checkpoint(folder, model, optimizer=None, epoch: int | None = None) -> int:
    """Restore the model (and the optimizer) in place from the latest
    checkpoint, or from epoch ``epoch``; returns that epoch."""
    folder = Path(folder)
    meta = json.loads((folder / "state.json").read_text())
    path = folder / "weights.pt" if epoch is None else folder / "epochs" / f"e{epoch}.pt"
    device = next(model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(blob["model"])
    if optimizer is not None:
        optimizer.load_state_dict(blob["optimizer"])
    return meta["epoch"] if epoch is None else epoch


def load_encoder_from_vae_ckpt(folder, size_latent: int, batchnorm: bool = True,
                               dropout_rate: float = 0.0, device="cuda"):
    """The frozen encoder (eval mode, with its logvar head and batch
    statistics) of a ``train_vae`` run directory: the port's
    ``weights.pt``, or the JAX package's ``weights.msgpack``.  (The JAX
    package's also takes the image size, to build a template; the port's
    encoder needs none.)"""
    from ..nn.vae import Encoder
    from ..nn.weights import encoder_from_jax, msgpack_restore

    dev = resolve_device(device)
    folder = Path(folder)
    encoder = Encoder(1, size_latent, dropout_rate=dropout_rate, batchnorm=batchnorm)
    if (folder / "weights.pt").exists():
        state = torch.load(folder / "weights.pt", map_location="cpu", weights_only=True)["model"]
        encoder.load_state_dict({k[len("encoder."):]: v for k, v in state.items()
                                 if k.startswith("encoder.")})
    else:
        tree = msgpack_restore((folder / "weights.msgpack").read_bytes())
        variables = {"params": tree["params"]["encoder"]}
        if batchnorm:
            variables["batch_stats"] = tree["batch_stats"]["encoder"]
        encoder.load_state_dict(encoder_from_jax(variables))
    return encoder.eval().to(dev)
