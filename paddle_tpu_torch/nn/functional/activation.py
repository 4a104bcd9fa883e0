"""Activations (counterparts of ``paddle_tpu/nn/functional/activation.py``):
plain tensor ops, as in the reference, where they are ``jax.nn`` calls and
no kernel."""
from __future__ import annotations

import torch


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, the tanh form when ``approximate``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return torch.relu(x)


def silu(x, name=None):
    return torch.nn.functional.silu(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


__all__ = ["gelu", "relu", "silu", "softmax"]
