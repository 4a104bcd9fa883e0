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

Under ZeRO-3 the forward run again in the backward gathers the sliced
weights again, as the first run did.

The flash-attention kernel K1 is not a product of either policy, so it
runs again in the backward under every granularity: a recomputed layer
launches K1 twice a step.

``recompute_sequential`` cuts a ``Sequential`` (or a list of callables)
into ``ctx["segments"]`` runs and recomputes each; ``recompute_hybrid``
is ``recompute`` after checking its ``ctx``: the reference's mp / pp RNG
sync and offload have nothing to do here (the RNG state is restored per
block, and nothing is stashed), and ``partition=True`` raises, as the
reference's.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ....framework import op as _op
from ..meta_parallel import sharding_stage3 as _z3

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
    gathering = _z3.gathering()

    def run(*a, **k):
        with _op.policy(state), _z3.resumed(gathering):
            return function(*a, **k)

    extra = {}
    if policy is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)


_KNOBS = ("use_reentrant", "preserve_rng_state", "policy", "granularity")


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``functions`` (a ``Sequential`` or a list) chained, in
    ``ctx["segments"]`` runs of ``len // segments`` each (the last may be
    shorter), each under :func:`recompute`. The first function takes
    ``*args`` and the keyword arguments other than recompute's own; each
    later one the previous one's output."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) else 1
    if isinstance(functions, torch.nn.Module):
        functions = list(functions.children())
    functions = list(functions)
    per = max(1, len(functions) // max(segments, 1))
    knobs = {k: kwargs.pop(k) for k in _KNOBS if k in kwargs}

    def run(chain, first_kwargs):
        def segment(*xs):
            y = chain[0](*xs, **first_kwargs)
            for f in chain[1:]:
                y = f(y)
            return y

        return segment

    cur, first = tuple(args), kwargs
    for i in range(0, len(functions), per):
        cur = (recompute(run(functions[i:i + per], first), *cur, **knobs),)
        first = {}
    return cur[0]


def recompute_hybrid(ctx, function, *args, **kwargs):
    """``recompute(function, *args, **kwargs)`` in hybrid parallelism
    (``ctx``: ``mp_group``, ``offload``, ``partition``); ``partition=True``
    (activation partitioning to the host) raises, as the reference's."""
    if isinstance(ctx, dict) and ctx.get("partition"):
        raise NotImplementedError(
            "recompute_hybrid(partition=True): activation-partition offload "
            "is not supported, as in the reference; use sharding (ZeRO-3) "
            "instead")
    return recompute(function, *args, **kwargs)


__all__ = ["policy_for_granularity", "recompute", "recompute_hybrid",
           "recompute_sequential"]
