"""LayerNorm, RMSNorm and the batch norms (counterparts of
``paddle_tpu/nn/layers/norm.py``): Paddle's ``epsilon`` argument, weight 1
(and bias 0) at init.

The batch norms keep their running statistics in the f32 buffers
``_mean`` (zeros) and ``_variance`` (ones), the reference's names, so
state names read ``bn1._mean``; ``momentum`` (default 0.9) weighs the
running value. They normalise by the batch's statistics in training mode
(unless ``use_global_stats``) and by the running ones in eval mode.
``SyncBatchNorm`` is ``BatchNorm`` on one card, as in the reference on a
single replica; the cross-card statistics wait for the distributed port
(ROADMAP.md §A.7)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import resolve_device
from .. import initializer as I
from ..functional.norm import _rms_norm, batch_norm, layer_norm, rms_norm
from ..layer import Layer, create_parameter


def _shape(normalized_shape):
    if isinstance(normalized_shape, int):
        return (int(normalized_shape),)
    return tuple(int(n) for n in normalized_shape)


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes. The weight
    (1 at init) and bias (0) follow ``weight_attr`` / ``bias_attr``
    (``ParamAttr``); ``False`` drops them."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalized_shape = _shape(normalized_shape)
        self.epsilon = float(epsilon)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = (None if weight_attr is False else create_parameter(
            self.normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), **kw))
        self.bias = (None if bias_attr is False else create_parameter(
            self.normalized_shape, bias_attr, is_bias=True, **kw))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}, epsilon={self.epsilon}"


class RMSNorm(Layer):
    """RMSNorm over the trailing ``normalized_shape`` axes, with a weight
    only (no bias), made by ``weight_attr``."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6,
                 weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalized_shape = _shape(normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = create_parameter(
            self.normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), device=device, dtype=dtype,
            generator=generator)

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}, epsilon={self.epsilon}"


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = (None if weight_attr is False else create_parameter(
            (num_features,), weight_attr,
            default_initializer=I.Constant(1.0), **kw))
        self.bias = (None if bias_attr is False else create_parameter(
            (num_features,), bias_attr, is_bias=True, **kw))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name, **kw)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics span every replica: under
    ``fleet.DistTrainStep`` every batch norm in training takes the global
    batch's statistics (``nn/functional/norm.py``), as the reference's one
    program over the global batch does; on one rank it is
    :class:`BatchNorm`."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with each batch norm below it (itself included)
        replaced by a ``SyncBatchNorm`` carrying its parameters and running
        statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            ref = layer._mean
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=ref.device)
            with torch.no_grad():
                if layer.weight is not None:
                    out.weight.copy_(layer.weight)
                    out.bias.copy_(layer.bias)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer.named_children()):
            new_sub = cls.convert_sync_batchnorm(sub)
            if new_sub is not sub:
                out.add_module(name, new_sub)
        return out


def layer_norm_direct(layer, x):
    """``layer(x)`` for a :class:`LayerNorm`, without the module call or
    the AMP gateway (see ``framework.op.amp_op``'s ``raw``)."""
    return nn.functional.layer_norm(x, layer.normalized_shape, layer.weight,
                                    layer.bias, layer.epsilon)


def rms_norm_direct(layer, x):
    """``layer(x)`` for an :class:`RMSNorm`, likewise."""
    return _rms_norm.raw(x, layer.weight, layer.epsilon,
                         x.dim() - layer.weight.dim())
