"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Same fan rule and formulas as the reference; the random draw comes from
an explicit ``torch.Generator`` (the reference draws from its splittable
JAX key, so the two give different numbers from one seed: parity tests
bridge weights instead). ``init(shape, device=..., dtype=...,
generator=...)`` returns a new tensor.
"""
from __future__ import annotations

import math

import torch


def _fans(shape):
    """(fan_in, fan_out) as the reference computes them: a 2-D weight is
    ``[in, out]``; from 3-D on, the conv layout ``[out_c, in_c, *spatial]``
    (so a stacked expert weight ``[E, d_model, d_hidden]`` gets
    ``fan_in = d_model * d_hidden``, as in the reference)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        return torch.full(tuple(shape), self.value, device=device,
                          dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, seed=0):
        self.mean, self.std = mean, std

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        w = torch.empty(tuple(shape), device=device, dtype=dtype)
        return w.normal_(self.mean, self.std, generator=generator)


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _sum_of_fans(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return fi + fo


class XavierUniform(_Xavier):
    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        limit = self.gain * math.sqrt(6.0 / self._sum_of_fans(shape))
        w = torch.empty(tuple(shape), device=device, dtype=dtype)
        return w.uniform_(-limit, limit, generator=generator)


class XavierNormal(_Xavier):
    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        std = self.gain * math.sqrt(2.0 / self._sum_of_fans(shape))
        w = torch.empty(tuple(shape), device=device, dtype=dtype)
        return w.normal_(0.0, std, generator=generator)


__all__ = ["Constant", "Initializer", "Normal", "XavierNormal",
           "XavierUniform"]
