"""Activations (counterparts of ``paddle_tpu/nn/functional/activation.py``):
plain tensor ops, as in the reference, where they are ``jax.nn`` calls and
no kernel. ``softmax`` and ``log_softmax`` are on the AMP black list;
``gelu``, ``silu`` and ``tanh`` on neither (they cast at O2 only)."""
from __future__ import annotations

import torch

from ...framework.op import amp_op


@amp_op("gelu")
def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, the tanh form when ``approximate``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return torch.relu(x)


@amp_op("silu")
def silu(x, name=None):
    return torch.nn.functional.silu(x)


@amp_op("tanh")
def tanh(x, name=None):
    return torch.tanh(x)


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


__all__ = ["gelu", "log_softmax", "relu", "silu", "softmax", "tanh"]
