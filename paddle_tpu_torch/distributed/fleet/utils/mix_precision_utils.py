"""``fleet.utils.mix_precision_utils`` (counterpart of
``paddle_tpu/distributed/fleet/utils/mix_precision_utils.py``):
``MixPrecisionLayer`` casts a model's f32 parameters to a low-precision
dtype, as ``amp.decorate(level="O2")`` does, and ``MixPrecisionOptimizer``
makes the optimizer it wraps step from f32: each low-precision parameter
gets an f32 master and f32 moments, its gradient is read as f32 (the
reference's ``main_grad`` contract; the port's ``multi_precision``
machinery, ``optimizer/__init__.py``).
"""
from __future__ import annotations

from ....nn.layer import Layer

__all__ = ["MixPrecisionLayer", "MixPrecisionOptimizer"]


class MixPrecisionLayer(Layer):
    """``layers`` with its f32 parameters cast to ``dtype`` in place; the
    state dict is the wrapped model's, under its own names."""

    def __init__(self, layers, dtype="float16"):
        super().__init__()
        from .... import amp

        self._layers = amp.decorate(layers, None, level="O2", dtype=dtype)
        self._dtype = dtype

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)


class MixPrecisionOptimizer:
    """``optimizer`` stepping low-precision parameters through f32 masters
    (its ``multi_precision`` turned on); every other attribute is the
    wrapped optimizer's."""

    def __init__(self, optimizer):
        self._inner = optimizer
        optimizer._multi_precision = True

    def __getattr__(self, item):
        if item == "_inner":  # absent while a copy is being rebuilt
            raise AttributeError(item)
        return getattr(self._inner, item)

    def step(self):
        return self._inner.step()

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)
