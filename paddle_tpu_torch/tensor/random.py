"""Random sampling (counterpart of ``paddle_tpu/tensor/random.py``).

Every draw comes from the port's generators (``framework/rng.py``: torch's
default generator of the device drawn on, which ``paddle.seed`` seeds), on
the default device unless an input tensor names another. An explicit
``seed`` (``uniform``, ``gaussian``) draws from a ``torch.Generator`` of its
own on that device. The streams differ from the reference's (Philox and
its splitting against JAX's threefry keys); shapes, dtypes and laws are
the reference's."""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype
from .creation import _shape


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed)) \
        if seed else None


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device(None)
    out = torch.empty(_shape(shape), dtype=convert_dtype(dtype)
                      or torch.float32, device=dev)
    return out.uniform_(float(min), float(max),
                        generator=_generator(seed, dev))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype or "float32", 0.0, 1.0)


def standard_normal(shape, dtype=None, name=None):
    return torch.randn(_shape(shape), dtype=convert_dtype(dtype)
                       or torch.float32, device=resolve_device(None))


randn = standard_normal


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """N(mean, std) samples: of ``shape`` (default ``[1]``) for scalar
    moments, of their broadcast shape where either is a tensor."""
    tensors = [t for t in (mean, std) if isinstance(t, torch.Tensor)]
    if tensors:
        shp = _shape(shape) if shape is not None else torch.broadcast_shapes(
            *(t.shape for t in tensors))
        z = torch.randn(shp, dtype=torch.float32, device=tensors[0].device)
        return z * std + mean
    return gaussian(shape if shape is not None else [1], mean, std)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype="float32", name=None):
    dev = resolve_device(None)
    out = torch.empty(_shape(shape), dtype=convert_dtype(dtype)
                      or torch.float32, device=dev)
    return out.normal_(float(mean), float(std),
                       generator=_generator(seed, dev))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=convert_dtype(dtype) or torch.int64,
                         device=resolve_device(None))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         dtype=convert_dtype(dtype) or x.dtype,
                         device=x.device)


def randperm(n, dtype="int64", name=None):
    return torch.randperm(int(n), dtype=convert_dtype(dtype),
                          device=resolve_device(None))


def bernoulli(x, name=None):
    """0 / 1 draws with the probabilities ``x``, in ``x``'s dtype."""
    return torch.bernoulli(x)


def poisson(x, name=None):
    return torch.poisson(x)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 category ids drawn from the weights ``x`` (last axis)."""
    return torch.multinomial(x, int(num_samples), bool(replacement))


def uniform_(x, min=-1.0, max=1.0, name=None):
    with torch.no_grad():
        return x.uniform_(float(min), float(max))


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(float(mean), float(std))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(float(lam))


def shuffle_(x, name=None):
    """``x``'s rows (axis 0) permuted in place."""
    with torch.no_grad():
        return x.copy_(x[torch.randperm(x.shape[0], device=x.device)])


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        return x.bernoulli_(float(p))


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    """Samples with ln X ~ N(mean, std), float32, of ``shape`` (default
    ``[1]``)."""
    out = torch.empty(_shape(shape or [1]), dtype=torch.float32,
                      device=resolve_device(None))
    return out.log_normal_(float(mean), float(std))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    with torch.no_grad():
        return x.log_normal_(float(mean), float(std))


def standard_gamma(x, name=None):
    """Gamma(alpha=x, rate=1) samples, elementwise."""
    return torch.distributions.Gamma(x, torch.ones_like(x)).sample()


def binomial(count, prob, name=None):
    """int64 Binomial(count, prob) samples, broadcast elementwise."""
    count, prob = torch.broadcast_tensors(count, prob)
    dt = prob.dtype if prob.is_floating_point() else torch.float32
    return torch.binomial(count.to(dt), prob.to(dt)).to(torch.int64)


__all__ = ["bernoulli", "bernoulli_", "binomial", "exponential_", "gaussian",
           "log_normal", "log_normal_", "multinomial", "normal", "normal_",
           "poisson", "rand", "randint", "randint_like", "randn", "randperm",
           "shuffle_", "standard_gamma", "standard_normal", "uniform",
           "uniform_"]
