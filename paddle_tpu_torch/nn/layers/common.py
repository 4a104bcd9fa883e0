"""Linear, Embedding, Dropout, Identity and Flatten (counterparts of
``paddle_tpu/nn/layers/common.py``), through the functionals of the same
names, so ``auto_cast`` casts their inputs.

``Linear`` keeps Paddle's ``[in_features, out_features]`` weight layout
(``y = x @ W + b``), so a reference state_dict bridges onto the port with
names and shapes unchanged. At model-parallel degree 1 the fleet layers
``ColumnParallelLinear`` / ``RowParallelLinear`` / ``VocabParallelEmbedding``
reduce to these.

Both take the reference's positional arguments (``Linear(in_features,
out_features, weight_attr, bias_attr, name)``, ``Embedding(num_embeddings,
embedding_dim, padding_idx, sparse, weight_attr, name)``); the port's own
arguments (``device``, ``dtype``, ``generator``, ``init_std`` and
``Linear``'s ``weight_init``) are keyword-only. Parameters are created on
the device given and initialised from the explicit ``torch.Generator``
given: by ``weight_attr``'s / ``bias_attr``'s initializer where a
``ParamAttr`` names one, else ``Linear``'s ``weight_init`` where given,
else normal with std ``init_std`` where given, else ``XavierNormal`` (the
reference's default); biases 0.
A ``ParamAttr`` also sets ``trainable`` and the ``learning_rate`` and
``regularizer`` the optimizer reads (``nn/layer.py``); ``bias_attr=False``
drops the bias.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import tensor as T
from .. import initializer as I
from ..functional import common as F
from ..layer import Layer, create_parameter


def _default_init(init_std):
    """``Normal(0, init_std)`` where a std is given, else the reference's
    ``XavierNormal``."""
    return I.XavierNormal() if init_std is None else I.Normal(0.0, init_std)


class Linear(Layer):
    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init_std: Optional[float] = None, weight_init=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = create_parameter(
            (in_features, out_features), weight_attr,
            default_initializer=weight_init or _default_init(init_std), **kw)
        self.bias = (create_parameter((out_features,), bias_attr,
                                      is_bias=True, **kw)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


def linear_direct(layer, x):
    """``layer(x)`` for a :class:`Linear`, without the module call or the
    AMP gateway (see ``framework.op.amp_op``'s ``raw``)."""
    return F.linear.raw(x, layer.weight, layer.bias)


class Embedding(Layer):
    """A lookup table ``[num_embeddings, embedding_dim]``. With
    ``padding_idx`` that row is zeroed at init and the outputs at that id
    are masked (the reference's rule); ``sparse`` is accepted, the
    gradient is dense."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init_std: Optional[float] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=_default_init(init_std), device=device,
            dtype=dtype, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """The reference's ``Dropout(p, axis, mode)``: no op at all when not
    training (in ``upscale_in_train``) or at ``p == 0``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Identity(Layer):
    """The input, unchanged; any arguments are ignored."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(Layer):
    """Axes ``start_axis`` .. ``stop_axis`` merged into one (the
    reference's ``flatten_op``)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return T.flatten(x, self.start_axis, self.stop_axis)
