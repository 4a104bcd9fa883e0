"""Common functionals (counterparts of
``paddle_tpu/nn/functional/common.py``): ``linear`` (Paddle's
``[in_features, out_features]`` weight layout, on the AMP white list),
``embedding`` and ``dropout``."""
from __future__ import annotations

import numpy as np
import torch

from ...framework.op import amp_op


@amp_op("linear", "white")
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``; the weight and
    bias are cast to x's dtype, as the reference casts them."""
    # a cast only where the dtypes differ: ``.to`` costs host time even as
    # a no-op, and serving is host-bound
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    out = x @ weight
    if bias is not None:
        out = out + (bias if bias.dtype == out.dtype else bias.to(out.dtype))
    return out


@amp_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; with ``padding_idx``
    the rows looked up at that id are zeros (the output is masked, so no
    gradient reaches the padding row). ``sparse`` is accepted as the
    reference accepts it: the gradient is dense either way."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


@amp_op("dropout_op")
def _dropout(x, p, mode):
    if mode == "upscale_in_train":
        return torch.nn.functional.dropout(x, p, training=True)
    keep = torch.empty_like(x).bernoulli_(1.0 - p).bool()
    return torch.where(keep, x, torch.zeros_like(x))


@amp_op("dropout_axis_op")
def _dropout_axis(x, p, axis, mode):
    """One keep draw per index of the ``axis`` dimensions, broadcast over
    the others: whole slices are dropped."""
    shape = [1] * x.dim()
    for a in axis:
        shape[a] = x.shape[a]
    keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
        1.0 - p).bool()
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout with the reference's arguments. ``upscale_in_train`` scales
    the kept values by ``1 / (1 - p)`` in training and is the identity
    otherwise; ``downscale_in_infer`` keeps them unscaled in training and
    multiplies by ``1 - p`` otherwise. ``axis`` (an int or a list) draws
    one keep decision per index along those dimensions. At ``p == 0``, or
    out of training in ``upscale_in_train``, no op runs."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f"mode must be one of {_DROPOUT_MODES}, got "
                         f"{mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p:
            return x * (1.0 - p)
        return x
    if axis is not None:
        axis = tuple(int(a) % x.dim() for a in np.atleast_1d(axis))
        return _dropout_axis(x, float(p), axis, mode)
    return _dropout(x, float(p), mode)


__all__ = ["dropout", "embedding", "linear"]
