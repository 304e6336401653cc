"""Training loops for the SDF network and the VAE (torch.optim)."""

from .checkpoints import load_checkpoint, load_encoder_from_vae_ckpt, save_checkpoint
from .df import DfTrainConfig, sample_points, train_df
from .vae import VaeTrainConfig, train_vae

__all__ = ["DfTrainConfig", "VaeTrainConfig", "load_checkpoint", "load_encoder_from_vae_ckpt",
           "sample_points", "save_checkpoint", "train_df", "train_vae"]
