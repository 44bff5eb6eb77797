from .nn import MultiHeadAttention
from .rnn import VariationalDropoutCell

__all__ = ["MultiHeadAttention", "VariationalDropoutCell"]
