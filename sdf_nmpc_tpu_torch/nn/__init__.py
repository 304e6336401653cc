"""Neural networks: NeuralDF, embeddings, the shipped-weights reader."""

from .activation import sine
from .embeddings import PositionEmbedding, embedding_for
from .neural_df import NeuralDF

__all__ = ["NeuralDF", "PositionEmbedding", "embedding_for", "sine"]
