from .nn import MultiHeadAttention

__all__ = ["MultiHeadAttention"]
