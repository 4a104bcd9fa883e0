"""TensorParallel (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``): wraps
a model built from mp layers, broadcasting its parameters at
construction (``fleet.distributed_model``'s rule) and deferring to it.
``state_dict`` and ``set_state_dict`` are the model's own, names
unprefixed."""
from __future__ import annotations

from ....nn.layer import Layer


class TensorParallel(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from .. import distributed_model

        self._layers = distributed_model(layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)
