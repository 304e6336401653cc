"""Neural networks: NeuralDF, the generic Mlp, embeddings, the shipped-weights
reader."""

from .activation import sine
from .embeddings import PositionEmbedding, embedding_for
from .mlp import Mlp, mlp_params_from_flax
from .neural_df import NeuralDF

__all__ = ["Mlp", "NeuralDF", "PositionEmbedding", "embedding_for", "mlp_params_from_flax",
           "sine"]
