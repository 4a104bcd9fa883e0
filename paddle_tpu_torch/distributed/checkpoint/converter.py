"""The topology-independent checkpoint form (counterpart of
``paddle_tpu/distributed/checkpoint/converter.py``, the reference's
checkpoint converter capability: re-slice checkpoints across parallel
configurations).

``canonical_state_dict(model, optimizer)`` names every entry by its place
in the plain model, whatever the layout the live one runs:

- a pipelined (or folded) stack's blocks by layer,
  ``{stack path}.{layer}.{leaf}`` (``gpt.decoder.3.attn.qkv_proj.weight``),
  the layer the block's place in the stack's ``_layer_order`` (interleaved
  stages included); a rank of a pipeline stage has its stage's layers
  only;
- an optimizer entry by its parameter's structured path,
  ``__opt__.{path}.{state key}``, never by a run-local ``param_{i}`` or
  name, a scalar accumulator (Adam's beta powers) per layer with its
  block's parameter, and the scheduler's state under
  ``__opt__.LR_Scheduler``. Under ZeRO-1/2 a rank has the entries of the
  parameters it owns; its accumulators are made (zeros, as a first step
  would make them) so that a restore has targets;
- a parameter split by the mp layers (``split_axis``) or by ZeRO-3 is a
  ``DTensor`` on the fleet topology's mesh (``Shard`` on ``mp`` /
  ``sharding``), its moments with it; anything else the tensor itself.

The values alias the live tensors (no copy: ``abstract`` changes nothing
here, where the reference builds shape stand-ins to avoid one), so
``checkpoint.save_state_dict`` writes them and ``restore_canonical`` /
``load_state_dict`` copy a checkpoint into them in place, re-sliced to the
live layout; ``apply_canonical`` does the same from a dict of whole
values. Missing keys raise ``KeyError``: resuming silently on fresh
initial values is worse than failing.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

OPT = "__opt__."


def _pipes(model):
    """``[(path, stack)]`` of the model's ``SpmdPipeline`` stacks."""
    from ..fleet.meta_parallel.pipeline_parallel import SpmdPipeline

    return [(path, m) for path, m in model.named_modules()
            if isinstance(m, SpmdPipeline)]


def _layer_key(path, layer, leaf):
    return f"{path}.{layer}.{leaf}" if path else f"{layer}.{leaf}"


def _entries(model):
    """``{canonical key: live tensor}`` of the model's state."""
    pipes = _pipes(model)
    prefixes = tuple(f"{p}." if p else "" for p, _ in pipes)
    out = {}
    for key, v in model.state_dict(keep_vars=True).items():
        if not pipes or not any(key.startswith(px) for px in prefixes):
            out[key] = v
    for path, pipe in pipes:
        n = len(pipe.blocks)
        for j, blk in enumerate(pipe.blocks):
            layer = pipe._layer_order[pipe.stage * n + j]
            for leaf, v in blk.state_dict(keep_vars=True).items():
                out[_layer_key(path, layer, leaf)] = v
    return out


def _layout_spec(p):
    """The mesh spec of a parameter's local part: ``mp`` on its
    ``split_axis`` (an mp shard at mp > 1), ``sharding`` on its ZeRO-3
    dim; None for a whole tensor."""
    from ..fleet.layers.mpu import _mp_group, is_mp_shard
    from ..fleet.meta_parallel.sharding_stage3 import zero3_spec

    spec = [None] * p.dim()
    if is_mp_shard(p) and _mp_group()[1] > 1:
        spec[p.split_axis] = "mp"
    z = zero3_spec(p)
    if z is not None and z.group.nranks > 1:
        spec[z.dim] = "sharding" if spec[z.dim] is None else \
            (spec[z.dim], "sharding")
    return tuple(spec) if any(e is not None for e in spec) else None


def _value(t, spec):
    """The canonical value of local tensor ``t`` laid out by ``spec``."""
    t = t.detach()
    if spec is None:
        return t
    from ..auto_parallel import _place
    from ..mesh import hcg_mesh
    from ..reshard import _norm_spec

    mesh = hcg_mesh()
    shape = [n * math.prod(mesh.get_dim_size(a) for a in e)
             for n, e in zip(t.shape, _norm_spec(spec, t.dim()))]
    return _place(t, mesh, spec, tuple(shape))


def _rules_optimizer(optimizer):
    """``(rules optimizer, owned(i))`` of a (fleet-wrapped) optimizer."""
    from ..fleet import GradientMergeOptimizer

    inner = getattr(optimizer, "_inner_opt", optimizer)
    if isinstance(inner, GradientMergeOptimizer):
        raise NotImplementedError(
            "canonical_state_dict of a GradientMergeOptimizer: its merge "
            "state has no canonical form, see ROADMAP.md §A.7 item 4")
    owns = getattr(optimizer, "owns", lambda i: True)
    return inner, owns


def canonical_state_dict(model, optimizer=None, abstract: bool = False
                         ) -> Dict[str, Any]:
    """Flat topology-independent snapshot of the model (+ optimizer) state
    (see the module docstring)."""
    from ...optimizer.lr import LRScheduler

    entries = _entries(model)
    out: Dict[str, Any] = {}
    path_of = {}
    for key, v in entries.items():
        out[key] = _value(v, _layout_spec(v))
        path_of[id(v)] = key
    if optimizer is None:
        return out
    inner, owns = _rules_optimizer(optimizer)
    for i, p in enumerate(inner._parameter_list):
        if not owns(i) or not p.requires_grad:
            continue
        if inner._accumulators[i] is None:
            inner._accumulators[i] = inner._init_state(p)
        path = path_of.get(id(p))
        if path is None:
            raise KeyError(f"optimizer parameter {i} ({tuple(p.shape)}) is "
                           "not a parameter of the model")
        spec = _layout_spec(p)
        for k, v in inner._accumulators[i].items():
            if not isinstance(v, torch.Tensor):  # Lamb's / Lars's marker
                continue
            same = tuple(v.shape) == tuple(p.shape)
            out[f"{OPT}{path}.{k}"] = _value(v, spec if same else None)
    if isinstance(inner._learning_rate, LRScheduler):
        out[OPT + "LR_Scheduler"] = inner._learning_rate.state_dict()
    return out


def _finish(optimizer, live):
    """After a restore: the scheduler's state set, the f32 masters made
    anew from the restored parameters."""
    if optimizer is None:
        return
    inner, _ = _rules_optimizer(optimizer)
    sched = live.get(OPT + "LR_Scheduler")
    if sched is not None:
        inner._learning_rate.set_state_dict(sched)
    inner._master.clear()


def restore_canonical(path, model, optimizer=None) -> Dict[str, Any]:
    """Restore a checkpoint of :func:`canonical_state_dict` into the live
    model / optimizer, in place and in their layout
    (``checkpoint.load_state_dict``: each rank reads only its part);
    returns the live canonical dict."""
    from . import load_state_dict

    live = canonical_state_dict(model, optimizer)
    load_state_dict(path, live)
    _finish(optimizer, live)
    return live


def apply_canonical(model, canonical: Dict[str, Any], optimizer=None):
    """Copy a canonical dict of whole values (``load_state_dict(path)``'s,
    or another layout's gathered one) into the live model / optimizer, each
    cut to the live layout. Raises ``KeyError`` listing what the dict
    lacks."""
    from torch.distributed.tensor import DTensor

    from ..auto_parallel import placements_to_spec
    from ..reshard import local_block

    live = canonical_state_dict(model, optimizer)
    missing = sorted(k for k in live if k not in canonical)
    if missing:
        raise KeyError(
            "checkpoint is missing entries for the live model/optimizer "
            f"(stale or pre-canonical format?): {missing[:8]}"
            f"{' ...' if len(missing) > 8 else ''}")
    with torch.no_grad():
        for key, tgt in live.items():
            src = canonical[key]
            if not isinstance(tgt, torch.Tensor):
                live[key] = src
                continue
            src = torch.as_tensor(src)
            if isinstance(tgt, DTensor):
                spec = placements_to_spec(tgt.process_mesh, tgt.placements,
                                          tgt.dim())
                src = local_block(src.to(tgt.device), tgt.process_mesh, spec)
                tgt = tgt.to_local()
            tgt.copy_(src.to(tgt.device, tgt.dtype))
    _finish(optimizer, live)
    return model


__all__ = ["OPT", "apply_canonical", "canonical_state_dict",
           "restore_canonical"]
