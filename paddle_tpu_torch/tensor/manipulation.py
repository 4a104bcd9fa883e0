"""Shape ops (counterparts of ``paddle_tpu/tensor/manipulation.py``),
under the reference's op names. They return views where torch can."""
from __future__ import annotations

from ..framework.op import amp_op


@amp_op("reshape_op")
def reshape(x, shape, name=None):
    return x.reshape(tuple(shape))


@amp_op("flatten_op")
def _flatten(x, start_axis, stop_axis):
    return x.flatten(start_axis, stop_axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis`` .. ``stop_axis`` of ``x`` merged into one."""
    return _flatten(x, int(start_axis), int(stop_axis))


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


__all__ = ["flatten", "getitem", "repeat_interleave", "reshape", "t",
           "transpose"]
