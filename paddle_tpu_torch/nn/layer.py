"""``ParamAttr``, parameter creation and the containers ``Sequential`` /
``LayerList`` (counterparts of those parts of ``paddle_tpu/nn/layer.py``).

A parameter made by :func:`create_parameter` is a ``torch.nn.Parameter``
that carries the reference ``Parameter``'s attributes: ``trainable``
(``requires_grad``), ``optimize_attr["learning_rate"]`` (the factor the
optimizer scales the learning rate by for it) and ``regularizer`` (applied
by the optimizer in place of its own), plus ``need_clip``. ``ParamAttr``'s
``name`` is not carried (a tensor's ``name`` is torch's own): the
optimizer's state keys stay by position, as the reference's are for
unnamed parameters.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
from torch import nn

from . import initializer as I


class ParamAttr:
    """paddle.ParamAttr parity: how one parameter is made and trained."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def create_parameter(shape, attr=None, *, is_bias=False,
                     default_initializer=None, device=None,
                     dtype=torch.float32,
                     generator: Optional[torch.Generator] = None):
    """A new parameter of ``shape``, drawn by ``attr.initializer``, else
    ``default_initializer``, else (as the reference) zeros for a bias and
    XavierNormal for a weight; ``attr`` a ``ParamAttr``, a name or None."""
    if not isinstance(attr, ParamAttr):
        attr = ParamAttr(name=attr if isinstance(attr, str) else None)
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    p = nn.Parameter(init(tuple(int(s) for s in shape), device=device,
                          dtype=dtype, generator=generator),
                     requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


class Sequential(nn.Sequential):
    """Layers called in order. Children are named ``"0"``, ``"1"``, ...
    as in the reference (so state names read ``downsample.1._mean``); an
    ``OrderedDict`` or ``(name, layer)`` tuples name them instead."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]


class LayerList(nn.ModuleList):
    """A list of layers named ``"0"``, ``"1"``, ... (the reference's
    ``LayerList``; ``torch.nn.ModuleList`` names and renumbers alike)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


__all__ = ["LayerList", "ParamAttr", "Sequential", "create_parameter"]
