"""Activation layers (counterpart of ``paddle_tpu/nn/layers/activation.py``):
one layer for each activation functional, calling it with the arguments
given at construction (positional ones in the functional's order after
``x``), as the reference's ``_simple`` does; ``PReLU`` with its learned
slope, ``RReLU`` drawing its training slopes from an explicit
``torch.Generator``, and ``Softmax2D``."""
from __future__ import annotations

import inspect
from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from ..layer import Layer, create_parameter


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
ReLU6 = _simple("relu6")
ELU = _simple("elu")
SELU = _simple("selu")
CELU = _simple("celu")
LeakyReLU = _simple("leaky_relu")
Sigmoid = _simple("sigmoid")
Hardsigmoid = _simple("hardsigmoid")
Hardswish = _simple("hardswish")
Hardtanh = _simple("hardtanh")
Hardshrink = _simple("hardshrink")
Softshrink = _simple("softshrink")
Tanhshrink = _simple("tanhshrink")
ThresholdedReLU = _simple("thresholded_relu")
GELU = _simple("gelu")
Silu = _simple("silu")
SiLU = Silu  # Paddle has both spellings
Swish = _simple("swish")
Mish = _simple("mish")
Softplus = _simple("softplus")
Softsign = _simple("softsign")
Tanh = _simple("tanh")
Softmax = _simple("softmax")
LogSoftmax = _simple("log_softmax")
LogSigmoid = _simple("log_sigmoid")
GLU = _simple("glu")
Maxout = _simple("maxout")


class PReLU(Layer):
    """``F.prelu`` with a learned slope: ``num_parameters`` of them (1, or
    one a channel), ``init`` at the start."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            (num_parameters,), weight_attr,
            default_initializer=I.Constant(init), device=device, dtype=dtype,
            generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    """``F.rrelu``: in training the slopes are drawn from ``generator``
    (default: the default generator of the input's device), in eval mode
    the mean slope."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self._generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=self._generator)


class Softmax2D(Layer):
    """Softmax over the channels (axis -3) of a 3-D or 4-D input."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(
                f"Softmax2D requires a 3D or 4D tensor, got rank {x.dim()}")
        return F.softmax(x, axis=-3)


__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "SiLU", "Sigmoid", "Silu", "Softmax", "Softmax2D", "Softplus",
           "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
           "ThresholdedReLU"]
