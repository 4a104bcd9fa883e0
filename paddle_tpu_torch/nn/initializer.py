"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Same fan rule and formulas as the reference; the random draw comes from
an explicit ``torch.Generator`` (the reference draws from its splittable
JAX key, so the two give different numbers from one seed: parity tests
bridge weights instead) and is made on the device asked for, never on the
host and copied. ``init(shape, device=..., dtype=..., generator=...)``
returns a new tensor. ``Assign``, ``Dirac`` and ``Bilinear`` are
deterministic and equal the reference's.

``set_global_initializer`` sets two module globals that nothing reads, as
in the reference (ROADMAP.md §C: a reference gap kept, not upstream's
behaviour).
"""
from __future__ import annotations

import math

import numpy as np
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


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high = low, high

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        w = torch.empty(tuple(shape), device=device, dtype=dtype)
        return w.uniform_(self.low, self.high, generator=generator)


class TruncatedNormal(Initializer):
    """A standard normal truncated to ``[a, b]``, then ``* std + mean`` (the
    bounds are in standard units, as the reference's)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        w = torch.empty(tuple(shape), device=device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return (w * self.std + self.mean).to(dtype)


class _Kaiming(Initializer):
    """He initialization: the gain ``sqrt(2 / (1 + slope^2))`` over
    ``fan_in`` (``nonlinearity`` is accepted and not read, as in the
    reference)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def _gain_fan(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        return math.sqrt(2.0 / (1 + self.negative_slope ** 2)), fi


class KaimingUniform(_Kaiming):
    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        gain, fi = self._gain_fan(shape)
        limit = gain * math.sqrt(3.0 / fi)
        w = torch.empty(tuple(shape), device=device, dtype=dtype)
        return w.uniform_(-limit, limit, generator=generator)


class KaimingNormal(_Kaiming):
    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        gain, fi = self._gain_fan(shape)
        w = torch.empty(tuple(shape), device=device, dtype=dtype)
        return w.normal_(0.0, gain / math.sqrt(fi), generator=generator)


class Assign(Initializer):
    """The given value (an array, a list or a tensor) of exactly
    ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        v = self.value
        v = (v.detach() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(v.shape)} != "
                             f"{tuple(shape)}")
        return v.to(device=device, dtype=dtype, copy=True)


class Orthogonal(Initializer):
    """``gain`` times an orthogonal matrix of ``[prod(shape[:-1]),
    shape[-1]]`` (the reference's ``jax.nn.initializers.orthogonal``: the
    Q of a normal draw's QR, its columns' signs fixed by R's diagonal,
    transposed when there are fewer rows than columns), reshaped."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("Orthogonal needs at least a 2-D shape")
        rows, cols = math.prod(shape[:-1]), shape[-1]
        a = torch.empty((max(rows, cols), min(rows, cols)), device=device,
                        dtype=torch.float32).normal_(generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(shape).to(dtype)


class Dirac(Initializer):
    """Identity convolution kernels: ``w[i, i % in_c, centre] = 1`` for
    ``i < min(out_c, in_c * groups)``."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        centres = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centres] = 1.0
        return torch.as_tensor(out).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """Bilinear-upsampling kernels for a transposed convolution's
    ``[out_c, in_c, kh, kw]`` weight (the reference's formula)."""

    def __call__(self, shape, *, device=None, dtype=torch.float32,
                 generator=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        oc, ic, kh, kw = shape
        out = np.zeros(tuple(shape), np.float32)
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        cy = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cx = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        ky = 1 - np.abs(np.arange(kh) / fh - cy)
        kx = 1 - np.abs(np.arange(kw) / fw - cx)
        kern = ky[:, None] * kx[None, :]
        for i in range(oc):
            out[i, i % ic] = kern
        return torch.as_tensor(out).to(device=device, dtype=dtype)


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Record the initializers in two module globals. Nothing reads them,
    as nothing does in the reference (ROADMAP.md §C)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def calculate_gain(nonlinearity, param=None):
    """The reference's gain table (``leaky_relu``'s slope defaults to
    0.01)."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]


__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "set_global_initializer"]
