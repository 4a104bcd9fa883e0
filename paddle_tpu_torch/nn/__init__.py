"""Layers and functionals of the port."""
from .layers.common import Dropout, Embedding, Linear
from .layers.norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm"]
