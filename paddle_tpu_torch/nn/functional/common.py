"""Common functionals (counterparts of
``paddle_tpu/nn/functional/common.py``): ``linear`` (Paddle's
``[in_features, out_features]`` weight layout, on the AMP white list),
``embedding`` and ``dropout``."""
from __future__ import annotations

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
def embedding(x, weight, name=None):
    """Rows of ``weight`` at the integer ids ``x``."""
    return torch.nn.functional.embedding(x, weight)


@amp_op("dropout_op")
def _dropout(x, p):
    return torch.nn.functional.dropout(x, p, training=True)


def dropout(x, p=0.5, training=True, name=None):
    """Upscale-in-train dropout; the identity when not training or at
    ``p == 0``, where the reference runs no op."""
    if not training or p == 0.0:
        return x
    return _dropout(x, float(p))


__all__ = ["dropout", "embedding", "linear"]
