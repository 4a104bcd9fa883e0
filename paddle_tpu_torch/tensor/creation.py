"""Tensor creation (counterpart of ``paddle_tpu/tensor/creation.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype


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


__all__ = ["to_tensor"]
