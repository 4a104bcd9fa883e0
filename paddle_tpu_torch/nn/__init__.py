"""Layers and functionals of the port."""
from .layer import (Layer, LayerDict, LayerList, ParamAttr, Parameter,
                    ParameterList, Sequential, create_parameter)
from .layers.activation import (CELU, ELU, GELU, GLU, Hardshrink,
                                Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                                LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                                ReLU, ReLU6, RReLU, SELU, Sigmoid, SiLU,
                                Silu, Softmax, Softmax2D, Softplus,
                                Softshrink, Softsign, Swish, Tanh,
                                Tanhshrink, ThresholdedReLU)
from .layers.activation import __all__ as _activations
from .layers.common import Dropout, Embedding, Flatten, Identity, Linear
from .layers.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose)
from .layers.loss import CrossEntropyLoss, MSELoss
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          LayerNorm, RMSNorm, SyncBatchNorm)
from .layers.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                             AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                             AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                             AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                             MaxPool3D)
from .layers.transformer import (MultiHeadAttention, Transformer,
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)
from .layers.transformer import __all__ as _transformer

__all__ = sorted(_activations + _transformer + [
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
    "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv1DTranspose", "Conv2D",
    "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "CrossEntropyLoss",
    "Dropout", "Embedding", "Flatten", "Identity", "Layer", "LayerDict",
    "LayerList", "LayerNorm", "Linear", "MSELoss", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "ParamAttr", "Parameter", "ParameterList", "RMSNorm",
    "Sequential", "SyncBatchNorm", "create_parameter"])
