"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .activation import (celu, elu, elu_, gelu, glu, gumbel_softmax,
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout, mish,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid,
                         silu, softmax, softplus, softshrink, softsign,
                         swish, tanh, tanhshrink, thresholded_relu)
from .activation import __all__ as _activations
# the flash_attention submodule first: imported later, it would rebind the
# package attribute ``flash_attention`` from the function to the module
from . import flash_attention as _flash_attention_module  # noqa: F401
from .attention import (decode_attention, flash_attention, mask_fill_value,
                        padded_attention, paged_attention,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .flash_attention import flash_attn_unpadded
from .conv import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                   adaptive_avg_pool3d, adaptive_max_pool1d,
                   adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                   avg_pool2d, avg_pool3d, conv1d, conv1d_transpose, conv2d,
                   conv2d_transpose, conv3d, conv3d_transpose, max_pool1d,
                   max_pool2d, max_pool3d)
from .loss import (cross_entropy, mse_loss, nll_loss,
                   softmax_with_cross_entropy)
from .norm import batch_norm, layer_norm, rms_norm

__all__ = sorted(_activations + ["adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm", "conv1d",
           "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "cross_entropy", "decode_attention", "dropout",
           "embedding", "flash_attention", "flash_attn_unpadded", "layer_norm", "linear",
           "mask_fill_value", "max_pool1d", "max_pool2d",
           "max_pool3d", "mse_loss", "nll_loss", "padded_attention",
           "paged_attention", "rms_norm",
           "scaled_dot_product_attention", "softmax_with_cross_entropy"])
