"""Layers and functionals of the port."""
from .layer import LayerList, ParamAttr, Sequential, create_parameter
from .layers.activation import GELU, LogSoftmax, ReLU, Silu, Softmax, Tanh
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

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv1DTranspose",
           "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "CrossEntropyLoss", "Dropout", "Embedding", "Flatten", "GELU",
           "Identity", "LayerList", "LayerNorm", "Linear", "LogSoftmax",
           "MSELoss", "MaxPool1D", "MaxPool2D", "MaxPool3D", "ParamAttr",
           "RMSNorm", "ReLU", "Sequential", "Silu", "Softmax",
           "SyncBatchNorm", "Tanh", "create_parameter"]
