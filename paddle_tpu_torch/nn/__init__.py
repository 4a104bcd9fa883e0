"""Layers and functionals of the port."""
from .layers.common import Embedding, Linear
from .layers.norm import LayerNorm

__all__ = ["Embedding", "LayerNorm", "Linear"]
