"""Shape ops (counterparts of ``paddle_tpu/tensor/manipulation.py``),
under the reference's op names. They return views where torch can."""
from __future__ import annotations

from ..framework.op import amp_op


@amp_op("reshape_op")
def reshape(x, shape, name=None):
    return x.reshape(tuple(shape))


@amp_op("transpose_op")
def transpose(x, perm, name=None):
    return x.permute(*perm)


def t(x, name=None):
    """The transpose of a matrix (a vector as given)."""
    if x.dim() < 2:
        return x
    if x.dim() == 2:
        return transpose(x, (1, 0))
    raise ValueError("t only supports tensors with ndim <= 2; use transpose")


@amp_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    return x.repeat_interleave(repeats, dim=axis)


@amp_op("getitem_op")
def getitem(x, index):
    """``x[index]``."""
    return x[index]


__all__ = ["getitem", "repeat_interleave", "reshape", "t", "transpose"]
