"""Tensor creation (counterpart of ``paddle_tpu/tensor/creation.py``).

A function given no tensor to follow creates on the default device
(``resolve_device(None)``: the card unless ``set_device`` chose another);
a ``*_like`` function creates beside its input. Default dtypes are the
reference's: float32 for floats; integers keep int64 where the reference,
its 64-bit types off, narrows to int32 (ROADMAP §C.19)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype
from ..framework.op import amp_op


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new tensor holding ``data`` (a tensor, an array,
    a scalar or nested lists of them) on ``place`` (a device as
    ``resolve_device`` takes it; default: the default device), in
    ``dtype``. Without a dtype, float64 data becomes float32,
    the reference's default float; other dtypes are kept. A floating
    tensor requires grad unless ``stop_gradient``."""
    dtype = convert_dtype(dtype)
    device = resolve_device(place)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=device, dtype=dtype, copy=True)
    else:
        if isinstance(data, (list, tuple)):
            data = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else x for x in data]
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            dtype = torch.float32
        out = torch.tensor(arr, dtype=dtype, device=device)
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out


def _shape(shape):
    """A shape given as an int, a tensor or a list of ints / 0-d tensors."""
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _float(dtype):
    return convert_dtype(dtype) or torch.float32


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_float(dtype),
                       device=resolve_device(None))


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_float(dtype),
                      device=resolve_device(None))


def full(shape, fill_value, dtype=None, name=None):
    """``shape`` filled with ``fill_value``; without ``dtype`` a float fill
    gives float32, an int int64, a bool bool."""
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    dtype = convert_dtype(dtype)
    if dtype is None and isinstance(fill_value, float):
        dtype = torch.float32
    return torch.full(_shape(shape), fill_value, dtype=dtype,
                      device=resolve_device(None))


def empty(shape, dtype=None, name=None):
    """Zeros, as the reference's ``empty`` gives."""
    return zeros(shape, dtype)


@amp_op("zeros_like_op")
def zeros_like_op(x):
    return torch.zeros_like(x)


@amp_op("ones_like_op")
def ones_like_op(x):
    return torch.ones_like(x)


def zeros_like(x, dtype=None, name=None):
    out = zeros_like_op(x)
    return out if dtype is None else out.to(convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    out = ones_like_op(x)
    return out if dtype is None else out.to(convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(x.shape, fill_value,
                      dtype=convert_dtype(dtype) or x.dtype, device=x.device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """``[start, end)`` by ``step`` (``arange(n)``: ``[0, n)``); int64 when
    every bound is an int, else float32."""
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    dt = convert_dtype(dtype)
    if dt is None:
        ints = builtins.all(isinstance(v, (int, np.integer))
                            for v in (start, end, step))
        dt = torch.int64 if ints else torch.float32
    return torch.arange(start, end, step, dtype=dt,
                        device=resolve_device(None))


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_float(dtype), device=resolve_device(None))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=_scalar(base), dtype=_float(dtype),
                          device=resolve_device(None))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    return torch.eye(n, n if num_columns is None else int(num_columns),
                     dtype=_float(dtype), device=resolve_device(None))


@amp_op("diag_op")
def diag_op(x, offset=0, padding_value=0):
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        n = out.shape[0]
        keep = torch.ones(n - builtins.abs(offset), dtype=torch.bool,
                          device=x.device)
        out = torch.where(torch.diag(keep, offset), out,
                          torch.tensor(padding_value, dtype=x.dtype,
                                       device=x.device))
    return out


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix (off it
    ``padding_value``), or the ``offset`` diagonal of a matrix ``x``."""
    return diag_op(x, offset=int(offset), padding_value=padding_value)


@amp_op("diagflat_reshape")
def reshape_raw(x):
    return x.reshape(-1)


def diagflat(x, offset=0, name=None):
    return diag_op(reshape_raw(x), offset=int(offset))


@amp_op("tril")
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@amp_op("triu")
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@amp_op("assign_op")
def assign_op(x):
    return x.clone()


def assign(x, output=None):
    """A copy of ``x`` (a tensor, or data for ``to_tensor``); with
    ``output``, written into it and returned."""
    if not isinstance(x, torch.Tensor):
        x = to_tensor(x, place=output.device if output is not None else None)
    out = assign_op(x)
    if output is None:
        return out
    output.data = out.detach()
    return output


def clone(x, name=None):
    return assign_op(x)


def numel(x, name=None):
    """The element count as a 0-d int64 tensor beside ``x``."""
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def meshgrid(*args, **kwargs):
    """Coordinate grids of 1-D tensors, ``"ij"`` indexing, as a list."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=convert_dtype(dtype),
                              device=resolve_device(None))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    return torch.triu_indices(int(row), int(row if col is None else col),
                              int(offset), dtype=convert_dtype(dtype),
                              device=resolve_device(None))


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows of the class ids ``x``."""
    return torch.nn.functional.one_hot(x.long(), int(num_classes)).to(
        torch.float32)


def complex(real, imag, name=None):  # noqa: A001 — paddle.complex
    return torch.complex(real, imag)


@amp_op("vander_op")
def _vander(x, n, increasing):
    return torch.vander(x, N=n, increasing=increasing)


def vander(x, n=None, increasing=False, name=None):
    return _vander(x, n=n, increasing=bool(increasing))


def shape(input):
    """paddle.shape: the shape as an int32 tensor beside ``input``."""
    return torch.tensor(tuple(input.shape), dtype=torch.int32,
                        device=input.device)


__all__ = ["arange", "assign", "assign_op", "clone", "complex", "diag",
           "diag_op", "diagflat", "empty", "empty_like", "eye", "full",
           "full_like", "linspace", "logspace", "meshgrid", "numel",
           "one_hot", "ones", "ones_like", "ones_like_op", "reshape_raw",
           "shape", "to_tensor", "tril", "tril_indices", "triu",
           "triu_indices", "vander", "zeros", "zeros_like", "zeros_like_op"]
