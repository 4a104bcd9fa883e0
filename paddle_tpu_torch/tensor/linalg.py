"""Matrix products (counterparts of ``paddle_tpu/tensor/linalg.py``), on
the AMP white list."""
from __future__ import annotations

import torch

from ..framework.op import amp_op


@amp_op("matmul", "white")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@amp_op("bmm", "white")
def bmm(x, y, name=None):
    return torch.bmm(x, y)


__all__ = ["bmm", "matmul"]
