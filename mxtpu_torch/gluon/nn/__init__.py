from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, HybridLambda,
                           HybridSequential, InstanceNorm, Lambda, LayerNorm,
                           LeakyReLU, PReLU, Sequential, Swish)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "ELU", "Embedding",
           "Flatten", "GELU", "HybridLambda", "HybridSequential",
           "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU", "PReLU",
           "SELU", "Sequential", "Swish", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "ReflectionPad2D"]
