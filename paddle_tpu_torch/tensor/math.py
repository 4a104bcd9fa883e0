"""Elementwise ops and reductions (counterparts of
``paddle_tpu/tensor/math.py``), under the reference's op names. Operands
of different dtypes promote as jnp promotes them (bf16 with f32 gives
f32)."""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype
from ..framework.op import amp_op


@amp_op("add")
def add(x, y, name=None):
    return x + y


@amp_op("multiply")
def multiply(x, y, name=None):
    return x * y


@amp_op("divide")
def divide(x, y, name=None):
    return x / y


@amp_op("clip")
def clip(x, min=None, max=None, name=None):
    return torch.clamp(x, min=min, max=max)


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


@amp_op("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Sum over ``axis`` (all axes when None), accumulated and returned in
    ``dtype`` (default: x's dtype, where torch would widen an integer x;
    int64 for a bool x), with the reference's argument order."""
    dtype = convert_dtype(dtype)
    if dtype is None:
        dtype = torch.int64 if x.dtype == torch.bool else x.dtype
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dtype)


@amp_op("mean")
def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


@amp_op("exp", "black")
def exp(x, name=None):
    return torch.exp(x)


@amp_op("log", "black")
def log(x, name=None):
    return torch.log(x)


__all__ = ["add", "clip", "divide", "exp", "log", "mean", "multiply", "sum"]
