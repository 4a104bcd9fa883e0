"""GroupSharded (ZeRO) wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding.py``): stage 1
shards the optimizer state by parameter over the sharding group, stage 2
also drops the gradients a rank does not own
(``fleet.HybridParallelOptimizer``); stage 3 cuts the parameters to
slices over the sharding group (``sharding_stage3.py``), and its
``state_dict`` / ``set_state_dict`` read and write the full arrays (every
rank calls them: the gather is a collective)."""
from __future__ import annotations

from ....nn.layer import Layer


class _GroupShardedBase(Layer):
    stage = 1

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 **kwargs):
        super().__init__()
        from .. import (DistributedStrategy, HybridParallelOptimizer,
                        _distribute, fleet_strategy)

        self._layers = _distribute(layer, self.stage)
        if optimizer is not None and \
                not isinstance(optimizer, HybridParallelOptimizer):
            strategy = fleet_strategy() or DistributedStrategy()
            strategy.sharding_configs["stage"] = self.stage
            optimizer = HybridParallelOptimizer(optimizer, strategy=strategy)
        self._optim = optimizer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        if self.stage == 3:
            from ....framework.io_state import gather_full_state

            return gather_full_state(self._layers)
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


class GroupShardedStage1(_GroupShardedBase):
    stage = 1


class GroupShardedStage2(_GroupShardedBase):
    stage = 2


class GroupShardedStage3(_GroupShardedBase):
    stage = 3
