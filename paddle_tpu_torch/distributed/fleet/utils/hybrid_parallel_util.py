"""Gradient and parameter synchronisation helpers (counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``), which
hybrid-parallel training scripts call between backward and step, and at
init:

- ``fused_allreduce_gradients``: average every present gradient over the
  data-parallel group (data and sharding axes together), in flat buckets
  of ``fuse_grad_size_in_MB`` (``distributed/grad_comm.py``);
- ``broadcast_dp_parameters`` / ``broadcast_mp_parameters`` /
  ``broadcast_sharding_parameters``: every parameter from the first rank
  of that axis's group; over mp only the replicated ones (an mp shard
  differs by rank on purpose, and is equal across the other axes).
"""
from __future__ import annotations

from ... import collective as C
from ... import grad_comm
from ..layers.mpu import is_mp_shard


def _hcg():
    from ..topology import get_hybrid_communicate_group

    return get_hybrid_communicate_group()


def fused_allreduce_gradients(parameter_list, hcg=None, bucket_mb=None):
    """Average the ``.grad`` of ``parameter_list`` over the data-parallel
    group, in place."""
    hcg = hcg or _hcg()
    if hcg is None:
        return
    group = hcg.get_data_sharding_parallel_group()
    params = [p for p in parameter_list if getattr(p, "grad", None) is not None]
    if bucket_mb is None:
        bucket_mb = grad_comm.resolve_config().bucket_mb
    grad_comm.allreduce_mean([p.grad for p in params], group, bucket_mb)


def _broadcast(model, group, skip_distributed):
    if group is None or group.nranks <= 1:
        return
    for p in model.parameters():
        if skip_distributed and is_mp_shard(p):
            continue
        C.broadcast(p.data, src=group.ranks[0], group=group)


def broadcast_dp_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_data_parallel_group(), False)


def broadcast_mp_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_model_parallel_group(), True)


def broadcast_sharding_parameters(model, hcg=None):
    hcg = hcg or _hcg()
    if hcg is not None:
        _broadcast(model, hcg.get_sharding_parallel_group(), False)


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


__all__ = ["broadcast_dp_parameters", "broadcast_mp_parameters",
           "broadcast_pp_replicated_parameters",
           "broadcast_sharding_parameters", "fused_allreduce_gradients"]
