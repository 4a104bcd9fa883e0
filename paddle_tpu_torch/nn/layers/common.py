"""Linear, Embedding and Dropout (counterparts of
``paddle_tpu/nn/layers/common.py``), through the functionals of the same
names, so ``auto_cast`` casts their inputs.

``Linear`` keeps Paddle's ``[in_features, out_features]`` weight layout
(``y = x @ W + b``), so a reference state_dict bridges onto the port with
names and shapes unchanged. At model-parallel degree 1 the fleet layers
``ColumnParallelLinear`` / ``RowParallelLinear`` / ``VocabParallelEmbedding``
reduce to these.

Parameters are created on the device given and initialised from the
explicit ``torch.Generator`` given: by ``weight_attr``'s / ``bias_attr``'s
initializer where a ``ParamAttr`` names one, else ``Linear``'s
``weight_init`` where given, else normal with std ``init_std``; biases 0.
A ``ParamAttr`` also sets ``trainable`` and the ``learning_rate`` and
``regularizer`` the optimizer reads (``nn/layer.py``); ``bias_attr=False``
drops the bias.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import initializer as I
from ..functional import common as F
from ..layer import create_parameter


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init_std: float = 0.02, weight_init=None, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = create_parameter(
            (in_features, out_features), weight_attr,
            default_initializer=weight_init or I.Normal(0.0, init_std), **kw)
        self.bias = (create_parameter((out_features,), bias_attr,
                                      is_bias=True, **kw)
                     if bias and bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


def linear_direct(layer, x):
    """``layer(x)`` for a :class:`Linear`, without the module call or the
    AMP gateway (see ``framework.op.amp_op``'s ``raw``)."""
    return F.linear.raw(x, layer.weight, layer.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init_std: float = 0.02, weight_attr=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=I.Normal(0.0, init_std), device=device,
            dtype=dtype, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Dropout):
    """``torch.nn.Dropout`` run as the reference's ``dropout``: no op at
    all when not training or at ``p == 0``."""

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
