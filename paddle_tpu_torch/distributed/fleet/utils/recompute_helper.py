"""Activation recomputation (counterpart of
``paddle_tpu/distributed/fleet/utils/recompute_helper.py``).

``recompute(fn, *args)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint`` (non-reentrant): the forward keeps
what the granularity's policy saves, and the backward runs ``fn`` again for
the rest, with the RNG state and the ``auto_cast`` policy of the first run.
Granularity, as the reference maps it onto XLA's policies:

- ``"full"`` (the models' default): only the block's inputs are kept;
- ``"full_attn"``, ``"core_attn"`` and ``"dots"``: the outputs of matrix
  products (``aten.mm`` / ``addmm`` / ``bmm``) are kept too, the
  elementwise tail runs again (the reference's ``dots_saveable``).

The flash-attention kernel K1 is not a product of either policy, so it
runs again in the backward under every granularity: a recomputed layer
launches K1 twice a step.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ....framework import op as _op

#: the products ``dots_saveable`` keeps
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default]


def policy_for_granularity(granularity):
    """The ops whose outputs a granularity keeps: None for ``"full"`` (the
    block's inputs only), the matrix products for ``"full_attn"`` /
    ``"core_attn"`` / ``"dots"``."""
    if granularity in (None, "full"):
        return None
    if granularity in ("full_attn", "core_attn", "dots"):
        return list(_DOTS)
    raise ValueError(
        f"unknown recompute_granularity {granularity!r}; expected 'full', "
        "'full_attn', 'core_attn' or 'dots'")


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              policy=None, granularity="dots", **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward. ``policy`` (a list of ops to keep, or a
    ``create_selective_checkpoint_contexts`` policy function) wins over
    ``granularity``. ``use_reentrant`` is accepted for the reference's
    signature; the checkpoint is always the non-reentrant one, which
    ``torch.autograd.grad`` needs."""
    if policy is None:
        policy = policy_for_granularity(granularity)
    state = _op.snapshot()

    def run(*a, **k):
        with _op.policy(state):
            return function(*a, **k)

    extra = {}
    if policy is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)


__all__ = ["policy_for_granularity", "recompute"]
