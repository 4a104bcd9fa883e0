"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .activation import gelu, log_softmax, relu, silu, softmax
from .attention import (flash_attention, mask_fill_value, paged_attention,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .loss import mse_loss
from .norm import layer_norm, rms_norm

__all__ = ["dropout", "embedding", "flash_attention", "gelu", "layer_norm",
           "linear", "log_softmax", "mask_fill_value", "mse_loss",
           "paged_attention", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu", "softmax"]
