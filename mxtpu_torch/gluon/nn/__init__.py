from .basic_layers import Dense, Embedding, LayerNorm

__all__ = ["Dense", "Embedding", "LayerNorm"]
