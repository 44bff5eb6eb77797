from .transformer import TransformerBlock, TransformerLM, transformer_lm

__all__ = ["TransformerBlock", "TransformerLM", "transformer_lm"]
