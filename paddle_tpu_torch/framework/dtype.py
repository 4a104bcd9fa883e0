"""Dtype names of the port (counterpart of ``paddle_tpu/framework/dtypes.py``):
Paddle's names map onto ``torch.dtype``s, and :func:`convert_dtype` reads
a dtype given as a Paddle / numpy name, a numpy dtype or a torch dtype."""
from __future__ import annotations

import numpy as np
import torch

#: Paddle's dtype names, each the ``torch.dtype`` the port computes in
DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def convert_dtype(dtype):
    """``dtype`` as a ``torch.dtype`` (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


#: torch dtype -> its Paddle / numpy name
NAMES = {v: k for k, v in DTYPES.items()}


def to_host(t):
    """``(array, dtype name)``: a tensor's values as a host numpy array.
    numpy has no bfloat16, so a bf16 tensor travels as its raw 16-bit words
    (an int16 array) and the name ``"bfloat16"`` tells them apart; a numpy
    array passes through with its own dtype's name."""
    if isinstance(t, np.ndarray):
        return t, t.dtype.name
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), NAMES[t.dtype]


def from_host(arr, name=None, device=None) -> torch.Tensor:
    """Inverse of :func:`to_host`: int16 words named ``"bfloat16"`` become
    a bf16 tensor again, bit for bit; other arrays keep their dtype."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if name == "bfloat16" and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t if device is None else t.to(device)


__all__ = ["DTYPES", "NAMES", "convert_dtype", "from_host", "to_host"]
