"""Neural networks: NeuralDF, the generic Mlp, embeddings, the perception
VAE and its blocks, the normalizer, the shipped-weights reader."""

from .activation import sine
from .embeddings import PositionEmbedding, embedding_for
from .mlp import Mlp, mlp_params_from_flax
from .neural_df import NeuralDF
from .normalizer import NormalizerStats, compute_stats, normalize
from .resnet import ConvTransposeTorch, ResBlock, ResBlockDeconv
from .vae import Decoder, Encoder, Vae, adaptive_avg_pool2d, sample_latent

__all__ = ["ConvTransposeTorch", "Decoder", "Encoder", "Mlp", "NeuralDF", "NormalizerStats",
           "PositionEmbedding", "ResBlock", "ResBlockDeconv", "Vae", "adaptive_avg_pool2d",
           "compute_stats", "embedding_for", "mlp_params_from_flax", "normalize",
           "sample_latent", "sine"]
