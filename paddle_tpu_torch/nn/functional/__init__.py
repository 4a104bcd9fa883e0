"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .activation import gelu, log_softmax, relu, silu, softmax, tanh
from .attention import (flash_attention, mask_fill_value, padded_attention,
                        paged_attention, scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .conv import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                   adaptive_avg_pool3d, adaptive_max_pool1d,
                   adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                   avg_pool2d, avg_pool3d, conv1d, conv1d_transpose, conv2d,
                   conv2d_transpose, conv3d, conv3d_transpose, max_pool1d,
                   max_pool2d, max_pool3d)
from .loss import (cross_entropy, mse_loss, nll_loss,
                   softmax_with_cross_entropy)
from .norm import batch_norm, layer_norm, rms_norm

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "batch_norm", "conv1d",
           "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "cross_entropy", "dropout", "embedding",
           "flash_attention", "gelu", "layer_norm", "linear", "log_softmax",
           "mask_fill_value", "max_pool1d", "max_pool2d", "max_pool3d",
           "mse_loss", "nll_loss", "padded_attention", "paged_attention",
           "relu", "rms_norm", "scaled_dot_product_attention", "silu",
           "softmax", "softmax_with_cross_entropy", "tanh"]
