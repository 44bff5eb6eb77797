from . import model_store, transformer, vision
from .transformer import TransformerBlock, TransformerLM, transformer_lm
from .vision import get_model

__all__ = ["TransformerBlock", "TransformerLM", "get_model", "model_store",
           "transformer", "transformer_lm", "vision"]
