"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .activation import gelu, relu, silu, softmax
from .attention import (flash_attention, mask_fill_value, paged_attention,
                        scaled_dot_product_attention)
from .loss import mse_loss
from .norm import rms_norm

__all__ = ["flash_attention", "gelu", "mask_fill_value", "mse_loss",
           "paged_attention", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu", "softmax"]
