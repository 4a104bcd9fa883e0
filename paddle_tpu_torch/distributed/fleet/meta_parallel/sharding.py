"""GroupSharded (ZeRO) wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding.py``): stage 1
shards the optimizer state by parameter over the sharding group, stage 2
also drops the gradients a rank does not own
(``fleet.HybridParallelOptimizer``). Stage 3 (sharded parameters) waits
for ROADMAP.md §A.7."""
from __future__ import annotations

from ....nn.layer import Layer


class _GroupShardedBase(Layer):
    stage = 1

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 **kwargs):
        super().__init__()
        if self.stage == 3:
            raise NotImplementedError(
                "GroupShardedStage3 (ZeRO-3) is not ported yet, see "
                "ROADMAP.md §A.7")
        from .. import (DistributedStrategy, HybridParallelOptimizer,
                        distributed_model, fleet_strategy)

        self._layers = distributed_model(layer)
        if optimizer is not None and \
                not isinstance(optimizer, HybridParallelOptimizer):
            strategy = fleet_strategy() or DistributedStrategy()
            strategy.sharding_configs["stage"] = self.stage
            optimizer = HybridParallelOptimizer(optimizer, strategy=strategy)
        self._optim = optimizer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


class GroupShardedStage1(_GroupShardedBase):
    stage = 1


class GroupShardedStage2(_GroupShardedBase):
    stage = 2


class GroupShardedStage3(_GroupShardedBase):
    stage = 3
