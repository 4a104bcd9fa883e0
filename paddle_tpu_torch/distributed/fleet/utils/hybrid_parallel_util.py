"""Gradient and parameter synchronisation helpers (counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``), which
hybrid-parallel training scripts call between backward and step, and at
init:

- ``fused_allreduce_gradients``: average every present gradient over the
  data-parallel group (data, sharding and sep axes together), in flat
  buckets of ``fuse_grad_size_in_MB`` (``distributed/grad_comm.py``),
  through the quantized wire when it is on (:func:`wire_exchange`); a
  MoE layer's expert slices over the ranks that hold the same experts,
  a ZeRO-3 slice's over the ranks that hold the same slice
  (:func:`allreduce_gradients`);
- ``broadcast_dp_parameters`` / ``broadcast_mp_parameters`` /
  ``broadcast_sharding_parameters`` / ``broadcast_sep_parameters``: every
  parameter from the first rank of that axis's group; over mp only the
  replicated ones (an mp shard differs by rank on purpose, and is equal
  across the other axes), and over the expert axis not the expert slices.
"""
from __future__ import annotations

import weakref

import torch

from ... import collective as C
from ... import grad_comm
from ..layers.mpu import is_mp_shard


def _hcg():
    from ..topology import get_hybrid_communicate_group

    return get_hybrid_communicate_group()


_wires = {}


def wire_exchange(params, hcg, strategy=None):
    """The quantized gradient exchange (``grad_comm.WireExchange``) of the
    trainable ``params`` over the data-parallel group, made once for that
    parameter list (its error-feedback residuals live on), or None: the
    wire off or f32, one data rank, or where the reference keeps its
    exact exchange (``grad_comm``'s module docstring), which a quantized
    wire warns of once."""
    from ....incubate.moe import is_expert_slice
    from ..meta_parallel.sharding_stage3 import is_zero3_slice, slice_dim

    if strategy is None:
        from .. import fleet_strategy

        strategy = fleet_strategy()
    cfg = grad_comm.resolve_config(strategy)
    group = hcg.get_dp_sep_parallel_group()
    if not (cfg.enable and cfg.quantized) or group.nranks == 1:
        return None
    key = (tuple(id(p) for p in params), id(hcg), cfg)
    hit = _wires.get(key)
    # ids are reused once their objects die: a hit counts only while its
    # parameters and hybrid group are the ones it was made for
    if hit is not None and hit[1] is hcg and \
            all(r() is p for r, p in zip(hit[0], params)):
        return hit[2]
    why = None
    if max(hcg.get_model_parallel_world_size(),
           hcg.get_pipe_parallel_world_size(),
           hcg.get_sep_parallel_world_size()) > 1:
        why = "model, pipe or sep parallelism"
    elif any(is_zero3_slice(p) or is_expert_slice(p) for p in params):
        why = "ZeRO-3 or expert slices"
    elif strategy is not None and getattr(strategy, "gradient_merge", False):
        why = "gradient_merge"
    elif any(p.dtype != torch.float32 for p in params):
        why = "low-precision parameters (f32 master weights)"
    if why is not None:
        grad_comm.warn_unapplied(cfg, why)
        return None
    nshards = hcg.get_sharding_parallel_world_size()
    dims = [slice_dim(p, nshards) if nshards > 1 else None for p in params]
    wire = grad_comm.plan_wire(cfg, params, group, nshards, dims)
    if wire is None:
        grad_comm.warn_unapplied(cfg, "sharded state and zero_update off")
    for k in [k for k, v in _wires.items()
              if any(r() is None for r in v[0])]:
        del _wires[k]  # a dead model's exchange and residuals
    _wires[key] = ([weakref.ref(p) for p in params], hcg, wire)
    return wire


def allreduce_gradients(params, grads, hcg, bucket_mb):
    """Average ``grads`` (those of ``params``, None where absent) over the
    hybrid group's data x sep ranks, in place: the replicated parameters'
    by a bucketed mean; a MoE layer's expert slices summed over the ranks
    holding the same experts and divided by the data x sep degree (each
    slice's gradient already sums the tokens the exchange brought it);
    a ZeRO-3 slice's (already summed over the sharding group) summed over
    the ranks holding the same slice and divided by that degree."""
    from ....incubate.moe import is_expert_slice
    from ..meta_parallel.sharding_stage3 import is_zero3_slice

    wire = wire_exchange(params, hcg)
    if wire is not None:
        wire(list(grads))
        return
    rep, expert, sliced = [], [], []
    for p, g in zip(params, grads):
        if g is not None:
            (expert if is_expert_slice(p) else
             sliced if is_zero3_slice(p) else rep).append(g)
    grad_comm.allreduce_mean(rep, hcg.get_dp_sep_parallel_group(), bucket_mb)
    if sliced:
        # summed over the sharding group by the gather's backward
        group = hcg.get_slice_replica_group()
        if group.nranks > 1:
            grad_comm.allreduce_sum(sliced, group, bucket_mb)
        n = hcg.get_dp_sep_parallel_world_size()
        for g in sliced:
            g.div_(n)
    if expert:
        grad_comm.allreduce_sum(expert, hcg.get_expert_replica_group(),
                                bucket_mb)
        n = hcg.get_dp_sep_parallel_world_size()
        for g in expert:
            g.div_(n)


def fused_allreduce_gradients(parameter_list, hcg=None, bucket_mb=None):
    """Average the ``.grad`` of ``parameter_list`` over the data-parallel
    group, in place (:func:`allreduce_gradients`)."""
    hcg = hcg or _hcg()
    if hcg is None:
        return
    params = [p for p in parameter_list if getattr(p, "grad", None) is not None]
    if bucket_mb is None:
        bucket_mb = grad_comm.resolve_config().bucket_mb
    allreduce_gradients(params, [p.grad for p in params], hcg, bucket_mb)


def _broadcast(model, group, axis, skip_distributed=False):
    """Every parameter from the group's first rank, but the mp shards (with
    ``skip_distributed``) and the expert slices split over ``axis``."""
    if group is None or group.nranks <= 1:
        return
    for p in model.parameters():
        if skip_distributed and is_mp_shard(p) or \
                p.__dict__.get("expert_axis") == axis:
            continue
        C.broadcast(p.data, src=group.ranks[0], group=group)


def broadcast_dp_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_data_parallel_group(), "data")


def broadcast_mp_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_model_parallel_group(), "model", True)


def broadcast_sharding_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_sharding_parallel_group(), "sharding")


def broadcast_sep_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_sep_parallel_group(), "sep")


def broadcast_pp_replicated_parameters(model, hcg=None):
    """The parameters outside a pipelined stack (replicated on every pipe
    rank) from the first stage to the others."""
    from ..meta_parallel.pipeline_parallel import is_pipeline_local

    hcg = hcg or _hcg()
    if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
        return
    group = hcg.get_pipe_parallel_group()
    for p in model.parameters():
        if not is_pipeline_local(p):
            C.broadcast(p.data, src=group.ranks[0], group=group)


__all__ = ["allreduce_gradients", "wire_exchange", "broadcast_dp_parameters",
           "broadcast_mp_parameters", "broadcast_pp_replicated_parameters",
           "broadcast_sep_parameters", "broadcast_sharding_parameters",
           "fused_allreduce_gradients"]
