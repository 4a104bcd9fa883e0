"""Activations (counterparts of ``paddle_tpu/nn/functional/activation.py``):
plain tensor ops, as in the reference, where they are ``jax.nn`` calls and
no kernel. Each keeps the reference's op name for ``auto_cast``:
``softmax`` and ``log_softmax`` are on the AMP black list, the others on
neither (they cast at O2 only).

Two of them draw random numbers, from torch's generators (the reference
draws from its threefry key stream, so parity runs them with the noise
fed in): ``gumbel_softmax`` its Gumbel noise from the default generator
of ``x``'s device, ``rrelu`` in training its slopes from ``generator``
(default: that same default generator). The reference's ``rrelu``
ignores ``training`` and always takes the mean slope."""
from __future__ import annotations

import torch

from ...framework.op import amp_op


@amp_op("gelu")
def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, the tanh form when ``approximate``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


@amp_op("relu")
def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    """In-place ReLU."""
    return x.relu_()


@amp_op("relu6")
def relu6(x, name=None):
    return torch.clamp(torch.relu(x), max=6.0)


@amp_op("elu")
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu_(x, alpha=1.0, name=None):
    """In-place ELU."""
    with torch.no_grad():
        out = elu(x, alpha)
    return x.copy_(out)


@amp_op("selu")
def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@amp_op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one weight for all, or
    one a channel (axis 1, or the last when ``data_format`` puts C
    last)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


@amp_op("rrelu")
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None,
          generator=None):
    """Randomized leaky ReLU: in training each negative element's slope is
    drawn from ``U(lower, upper)`` (``generator``); otherwise the mean
    slope ``(lower + upper) / 2``."""
    if training:
        u = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32)
        neg = (lower + (upper - lower) * u).to(x.dtype)
    else:
        neg = (lower + upper) / 2.0
    return torch.where(x >= 0, x, neg * x)


@amp_op("softmax", "black")
def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


@amp_op("log_softmax", "black")
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.log_softmax(x, dim=axis)


def _gumbel_noise(x):
    """Standard Gumbel noise of ``x``'s shape and dtype, from the default
    generator of its device."""
    u = torch.rand(x.shape, device=x.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return (-torch.log(-torch.log(u.clamp(min=tiny)))).to(x.dtype)


@amp_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g``; with
    ``hard`` the one-hot of its argmax, the gradient the soft sample's
    (straight through)."""
    y = torch.softmax((x + _gumbel_noise(x)) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


@amp_op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@amp_op("hardswish")
def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@amp_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


@amp_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@amp_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@amp_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@amp_op("silu")
def silu(x, name=None):
    return torch.nn.functional.silu(x)


@amp_op("swish")
def swish(x, name=None):
    return torch.nn.functional.silu(x)


def _softplus(x):
    """``log(1 + exp(x))`` for every ``x`` (``jax.nn.softplus``; torch's
    returns ``x`` itself above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@amp_op("mish")
def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


@amp_op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


@amp_op("softsign")
def softsign(x, name=None):
    return x / (1.0 + x.abs())


@amp_op("tanh")
def tanh(x, name=None):
    return torch.tanh(x)


@amp_op("glu")
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@amp_op("maxout")
def maxout(x, groups, axis=1, name=None):
    """The largest of each ``groups`` consecutive channels of ``axis``."""
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


@amp_op("log_sigmoid")
def log_sigmoid(x, name=None):
    return -_softplus(-x)


__all__ = ["celu", "elu", "elu_", "gelu", "glu", "gumbel_softmax",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "leaky_relu", "log_sigmoid", "log_softmax", "maxout", "mish",
           "prelu", "relu", "relu6", "relu_", "rrelu", "selu", "sigmoid",
           "silu", "softmax", "softplus", "softshrink", "softsign", "swish",
           "tanh", "tanhshrink", "thresholded_relu"]
