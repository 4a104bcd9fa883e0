"""Absmax int8 quantization (the wire helpers of
``paddle_tpu/distributed/grad_comm.py``; the serving engine's int8 KV pool
uses them with the head_dim axis for per-[page, head, position] scales).
The rest of grad_comm (bucketing, the quantized collective wire) is ported
with distributed training."""
from __future__ import annotations

import torch

_INT8_LEVELS = 127.0


def quantize_absmax(v, axis=None):
    """Symmetric int8 quantization with an absmax scale over ``axis``
    (``None`` = one scale for the whole tensor). Returns
    ``(q_int8, scale_f32)``; ``scale`` keeps the reduced dims. Rounds half
    to even, as the reference does."""
    vf = v.float()
    if axis is None:
        amax = vf.abs().amax().reshape((1,) * vf.dim())
    else:
        amax = vf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / _INT8_LEVELS,
                        min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(vf / scale), -_INT8_LEVELS, _INT8_LEVELS)
    return q.to(torch.int8), scale


def dequantize_absmax(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_absmax` (``scale`` broadcasts over the
    axes it kept)."""
    return (q.float() * scale).to(dtype)
