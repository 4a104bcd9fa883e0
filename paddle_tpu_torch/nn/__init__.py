"""Layers and functionals of the port."""
from .layer import ParamAttr, create_parameter
from .layers.common import Dropout, Embedding, Linear
from .layers.loss import CrossEntropyLoss, MSELoss
from .layers.norm import LayerNorm, RMSNorm

__all__ = ["CrossEntropyLoss", "Dropout", "Embedding", "LayerNorm", "Linear",
           "MSELoss", "ParamAttr", "RMSNorm", "create_parameter"]
