"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): plain tensor ops, as in the
reference, where they are jnp and no kernel."""
from __future__ import annotations

import torch


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


__all__ = ["rms_norm"]
