"""paddle.distributed.sharding (counterpart of
``paddle_tpu/distributed/sharding/__init__.py``): ``group_sharded_parallel``
and ``save_group_sharded_model``.

Levels: ``"os"`` (ZeRO-1, optimizer state sharded by parameter over the
sharding group) and ``"os_g"`` (ZeRO-2, also the gradients a rank does not
own dropped before the update), both through
``fleet.HybridParallelOptimizer``; ``"p_g_os"`` (ZeRO-3: the parameters,
their gradients and their optimizer state cut to slices over the sharding
group, ``fleet/meta_parallel/sharding_stage3.py``). ``fleet.init`` with a
sharding degree must come first. ``buffer_max_size`` sets the gradient
buckets' size, as in the reference.
"""
from __future__ import annotations

import os

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload=False,
                           sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False,
                           dp_group=None, exclude_layer=None):
    """Returns ``(model, optimizer, scaler)``: the model's parameters
    broadcast so every rank starts equal, the optimizer sharded."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {list(_LEVELS)}, "
                         f"got {level!r}")
    from ..fleet import (DistributedStrategy, HybridParallelOptimizer,
                         _distribute, fleet_strategy)

    strategy = fleet_strategy() or DistributedStrategy()
    strategy.sharding_configs["stage"] = _LEVELS[level]
    if buffer_max_size:
        strategy.grad_comm_configs["bucket_mb"] = \
            float(buffer_max_size) / 2 ** 20
    model = _distribute(model, _LEVELS[level])
    if isinstance(optimizer, HybridParallelOptimizer):
        optimizer = optimizer._inner_opt
    return model, HybridParallelOptimizer(optimizer, strategy=strategy), \
        scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the model's full state (the mp shards and ZeRO-3 slices
    gathered) to
    ``output + ".pdparams"`` from global rank 0, and with ``optimizer``
    each rank's own optimizer state to ``output + ".rank{r}.pdopt"``.
    Every rank calls it (the gather is a collective)."""
    from ...framework.io_state import gather_full_state, save
    from ..env import get_rank

    base = output[:-len(".pdparams")] if output.endswith(".pdparams") \
        else output
    state = gather_full_state(model)
    rank = get_rank()
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
        save(state, base + ".pdparams")
    if optimizer is not None:
        save(optimizer.state_dict(), f"{base}.rank{rank}.pdopt")
