"""LayerNorm and RMSNorm (counterparts of ``paddle_tpu/nn/layers/norm.py``):
Paddle's ``epsilon`` argument, weight 1 (and LayerNorm's bias 0) at init."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import _rms_norm, layer_norm, rms_norm


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape[0]}, epsilon={self.epsilon}"


class RMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` axes, with a weight
    only (no bias)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(n) for n in normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}, epsilon={self.epsilon}"


def layer_norm_direct(layer, x):
    """``layer(x)`` for a :class:`LayerNorm`, without the module call or
    the AMP gateway (see ``framework.op.amp_op``'s ``raw``)."""
    return nn.functional.layer_norm(x, layer.normalized_shape, layer.weight,
                                    layer.bias, layer.epsilon)


def rms_norm_direct(layer, x):
    """``layer(x)`` for an :class:`RMSNorm`, likewise."""
    return _rms_norm.raw(x, layer.weight, layer.epsilon,
                         x.dim() - layer.weight.dim())
