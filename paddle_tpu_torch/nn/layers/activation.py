"""Activation layers (counterpart of ``paddle_tpu/nn/layers/activation.py``):
one layer for each activation functional the port has, calling it with
the arguments given at construction (positional ones in the
functional's order after ``x``), as the reference's ``_simple`` does."""
from __future__ import annotations

import inspect

from .. import functional as F
from ..layer import Layer


def _simple(fn_name):
    fn = getattr(F, fn_name)
    names = [p for p in inspect.signature(fn).parameters][1:]

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = dict(zip(names, args))
            self._kwargs.update((k, v) for k, v in kwargs.items()
                                if k != "name")

        def forward(self, x):
            return fn(x, **self._kwargs)

        def extra_repr(self):
            return ", ".join(f"{k}={v!r}" for k, v in self._kwargs.items())

    _Act.__name__ = _Act.__qualname__ = fn_name
    return _Act


ReLU = _simple("relu")
GELU = _simple("gelu")
Silu = _simple("silu")
Tanh = _simple("tanh")
Softmax = _simple("softmax")
LogSoftmax = _simple("log_softmax")

__all__ = ["GELU", "LogSoftmax", "ReLU", "Silu", "Softmax", "Tanh"]
