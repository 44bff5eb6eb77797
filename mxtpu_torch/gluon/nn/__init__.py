from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, HybridLambda,
                           HybridSequential, InstanceNorm, Lambda, LayerNorm,
                           LeakyReLU, PReLU, Sequential, Swish)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "ELU", "Embedding",
           "Flatten", "GELU", "HybridLambda", "HybridSequential",
           "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU", "PReLU",
           "SELU", "Sequential", "Swish"]
