"""Neural networks: NeuralDF, the generic Mlp, embeddings, the perception
VAE and its blocks, flax's dropout, the conv initializer, the normalizer,
the shipped-weights reader."""

from .activation import sine
from .dropout import Dropout, set_dropout_generator
from .embeddings import PositionEmbedding, embedding_for
from .initializers import apply_conv_init
from .mlp import Mlp, mlp_params_from_flax, mlp_params_to_flax
from .neural_df import NeuralDF
from .normalizer import NormalizerStats, compute_stats, normalize
from .resnet import BatchNorm, ConvTransposeTorch, ResBlock, ResBlockDeconv
from .vae import Decoder, Encoder, Vae, adaptive_avg_pool2d, sample_latent

__all__ = ["BatchNorm", "ConvTransposeTorch", "Decoder", "Dropout", "Encoder", "Mlp", "NeuralDF",
           "NormalizerStats", "PositionEmbedding", "ResBlock", "ResBlockDeconv", "Vae",
           "adaptive_avg_pool2d", "apply_conv_init", "compute_stats", "embedding_for",
           "mlp_params_from_flax", "mlp_params_to_flax", "normalize", "sample_latent",
           "set_dropout_generator", "sine"]
