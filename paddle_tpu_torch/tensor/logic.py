"""Comparisons, logical and bitwise ops (counterpart of
``paddle_tpu/tensor/logic.py``), under the reference's op names."""
from __future__ import annotations

import torch

from ..framework.op import amp_op


@amp_op("equal")
def equal(x, y, name=None):
    return torch.eq(x, y)


@amp_op("not_equal")
def not_equal(x, y, name=None):
    return torch.ne(x, y)


@amp_op("greater_than")
def greater_than(x, y, name=None):
    return torch.gt(x, y)


@amp_op("greater_equal")
def greater_equal(x, y, name=None):
    return torch.ge(x, y)


@amp_op("less_than")
def less_than(x, y, name=None):
    return torch.lt(x, y)


@amp_op("less_equal")
def less_equal(x, y, name=None):
    return torch.le(x, y)


@amp_op("logical_and")
def logical_and(x, y, out=None, name=None):
    return torch.logical_and(x, y)


@amp_op("logical_or")
def logical_or(x, y, out=None, name=None):
    return torch.logical_or(x, y)


@amp_op("logical_xor")
def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(x, y)


@amp_op("logical_not")
def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


@amp_op("bitwise_and")
def bitwise_and(x, y, out=None, name=None):
    return torch.bitwise_and(x, y)


@amp_op("bitwise_or")
def bitwise_or(x, y, out=None, name=None):
    return torch.bitwise_or(x, y)


@amp_op("bitwise_xor")
def bitwise_xor(x, y, out=None, name=None):
    return torch.bitwise_xor(x, y)


@amp_op("bitwise_not")
def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(x)


bitwise_invert = bitwise_not


@amp_op("bitwise_left_shift")
def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return torch.bitwise_left_shift(x, y)


@amp_op("bitwise_right_shift")
def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    """``x >> y``; with ``is_arithmetic=False`` a signed ``x`` shifts in
    zeros from the left (the bits read as unsigned)."""
    out = torch.bitwise_right_shift(x, y)
    if is_arithmetic or not x.dtype.is_signed:
        return out
    bits = torch.iinfo(x.dtype).bits
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    # the low (bits - y) bits: (1 << (bits - y)) - 1 wraps to the type's
    # max at y = 1, as two's complement does
    low = torch.bitwise_left_shift(torch.ones_like(y), bits - y) - 1
    return torch.where(y == 0, x, out & low)


@amp_op("isclose_op")
def _isclose(x, y, rtol, atol, equal_nan):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return _isclose(x, y, rtol=float(rtol), atol=float(atol),
                    equal_nan=bool(equal_nan))


@amp_op("allclose_op")
def _allclose(x, y, rtol, atol, equal_nan):
    return torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan),
                        device=x.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor: every element of ``x`` close to ``y``'s."""
    return _allclose(x, y, rtol=float(rtol), atol=float(atol),
                     equal_nan=bool(equal_nan))


@amp_op("equal_all")
def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every element equal."""
    same = x.shape == y.shape and bool(torch.eq(x, y).all())
    return torch.tensor(same, device=x.device)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


@amp_op("isin")
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    """Elementwise membership of ``x`` in ``test_x``."""
    return torch.isin(x, test_x, assume_unique=assume_unique, invert=invert)


__all__ = ["allclose", "bitwise_and", "bitwise_invert", "bitwise_left_shift",
           "bitwise_not", "bitwise_or", "bitwise_right_shift", "bitwise_xor",
           "equal", "equal_all", "greater_equal", "greater_than", "is_empty",
           "is_tensor", "isclose", "isin", "less_equal", "less_than",
           "logical_and", "logical_not", "logical_or", "logical_xor",
           "not_equal"]
