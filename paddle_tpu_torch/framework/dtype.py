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


__all__ = ["DTYPES", "convert_dtype"]
