"""Layers and functionals of the port."""
from .layers.common import Embedding, Linear
from .layers.norm import LayerNorm, RMSNorm

__all__ = ["Embedding", "LayerNorm", "Linear", "RMSNorm"]
