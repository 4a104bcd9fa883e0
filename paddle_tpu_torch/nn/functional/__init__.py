"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .activation import gelu, log_softmax, relu, silu, softmax, tanh
from .attention import (flash_attention, mask_fill_value, padded_attention,
                        paged_attention, scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .loss import (cross_entropy, mse_loss, nll_loss,
                   softmax_with_cross_entropy)
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "dropout", "embedding", "flash_attention",
           "gelu", "layer_norm", "linear", "log_softmax", "mask_fill_value",
           "mse_loss", "nll_loss", "padded_attention", "paged_attention",
           "relu", "rms_norm", "scaled_dot_product_attention", "silu",
           "softmax", "softmax_with_cross_entropy", "tanh"]
