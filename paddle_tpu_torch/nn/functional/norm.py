"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): plain tensor ops, as in the
reference, where they are jnp and no kernel. Both are on the AMP black
list: under ``auto_cast`` they take and return f32."""
from __future__ import annotations

import torch

from ...framework.op import amp_op


@amp_op("layer_norm_op", "black")
def _layer_norm(x, weight, bias, epsilon, normalized_shape):
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _layer_norm(x, weight, bias, float(epsilon),
                       tuple(normalized_shape))


@amp_op("rms_norm_op", "black")
def _rms_norm(x, weight, epsilon, begin_axis):
    axes = tuple(range(begin_axis, x.dim()))
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=axes, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the trailing ``weight.dim()`` axes (the last axis
    without a weight): normalised in f32, cast back to ``x``'s dtype, then
    scaled by ``weight``."""
    begin = x.dim() - (weight.dim() if weight is not None else 1)
    return _rms_norm(x, weight, float(epsilon), begin)


__all__ = ["layer_norm", "rms_norm"]
