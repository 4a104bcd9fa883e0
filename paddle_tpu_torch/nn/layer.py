"""``Layer``, ``Parameter``, ``ParamAttr``, parameter creation and the
containers ``Sequential`` / ``LayerList`` / ``ParameterList`` /
``LayerDict`` (counterparts of ``paddle_tpu/nn/layer.py``).

``Layer`` is a ``torch.nn.Module`` that carries Paddle's methods. Torch's
registration, ``state_dict`` keys and autograd stay as they are, and every
torch signature keeps working: Paddle's keywords (``include_sublayers``,
``structured_name_prefix``, ``persistable``, ...) sit beside torch's
(``recurse``, ``prefix``, ``persistent``, ...). ``parameters()`` and
``buffers()`` return lists, as the reference's do, that ``next()`` also
reads from the front, as torch's generators are read.

Where the reference departs from upstream Paddle, the port takes upstream's
behaviour (ROADMAP §C.20, §C.21): a sublayer's non-persistable buffer stays
out of every ``state_dict``, and each hook keeps its own handle.

A parameter made by :func:`create_parameter` is a :class:`Parameter`: a
``torch.nn.Parameter`` that carries the reference ``Parameter``'s
attributes: ``trainable`` (``requires_grad``), ``persistable``,
``optimize_attr["learning_rate"]`` (the factor the optimizer scales the
learning rate by for it), ``regularizer`` (applied by the optimizer in
place of its own), ``need_clip`` and ``name``: ``ParamAttr(name=)``'s, or
None. The optimizer keys a named parameter's state by that name, as the
reference does (``optimizer/__init__.py``), and Lamb / Lars match their
weight-decay exclusions on it. A parameter without a ``ParamAttr`` name
stays unnamed, as in the reference: torch's module path is not a name.
"""
from __future__ import annotations

import collections
import copy
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..framework.dtype import DTYPES, convert_dtype
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


def _rebuild_parameter(data, requires_grad, state):
    p = Parameter(data, requires_grad)
    p.__dict__.update(state)
    return p


class Parameter(nn.Parameter):
    """paddle's Parameter: a ``torch.nn.Parameter`` with the reference's
    attributes. ``trainable`` and ``stop_gradient`` read and set
    ``requires_grad``. Copies and pickles keep the class and the
    attributes (torch's own keep neither)."""

    def __new__(cls, data=None, requires_grad=True, *, trainable=None):
        if trainable is not None:
            requires_grad = bool(trainable)
        p = super().__new__(cls, data, requires_grad)
        p.persistable = True
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        p.name = None
        return p

    # torch's ``Tensor.name`` is a read-only None; Paddle's is settable
    name = property(lambda self: self.__dict__.get("_name"),
                    lambda self, v: self.__dict__.__setitem__("_name", v))
    trainable = property(lambda self: self.requires_grad,
                         lambda self, v: self.requires_grad_(bool(v)))
    stop_gradient = property(lambda self: not self.requires_grad,
                             lambda self, v: self.requires_grad_(not v))

    def __deepcopy__(self, memo):
        out = super().__deepcopy__(memo)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (self.data, self.requires_grad, dict(self.__dict__)))


def create_parameter(shape, attr=None, *, is_bias=False,
                     default_initializer=None, device=None,
                     dtype=torch.float32,
                     generator: Optional[torch.Generator] = None):
    """A new :class:`Parameter` of ``shape``, drawn by ``attr.initializer``,
    else ``default_initializer``, else (as the reference) zeros for a bias
    and XavierNormal for a weight; ``attr`` a ``ParamAttr``, a name or
    None; ``dtype`` a torch dtype or a Paddle name. ``device`` None is the
    default device (``resolve_device``)."""
    if not isinstance(attr, ParamAttr):
        attr = ParamAttr(name=attr if isinstance(attr, str) else None)
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    p = Parameter(init(tuple(int(s) for s in shape),
                       device=resolve_device(device),
                       dtype=convert_dtype(dtype), generator=generator),
                  trainable=attr.trainable)
    p.name = attr.name
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


class _Listed(list):
    """A list that ``next()`` also reads from the front: Paddle's
    ``parameters()`` is a list, torch's a generator that callers read with
    ``next(m.parameters())``."""

    def __next__(self):
        i = self.__dict__.get("_next", 0)
        if i >= len(self):
            raise StopIteration
        self._next = i + 1
        return self[i]


def _device(device):
    """``device`` as torch reads it: Paddle's ``"gpu"`` / ``"gpu:N"`` name
    CUDA device 0 / N; anything else passes as given."""
    if isinstance(device, str) and device.lower().startswith("gpu"):
        return "cuda" + device[3:]
    return device


class Layer(nn.Module):
    """paddle.nn.Layer: a ``torch.nn.Module`` with Paddle's methods
    (reference ``paddle_tpu/nn/layer.py:60``). ``dtype`` is the dtype
    :meth:`create_parameter` makes parameters in by default."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._full_name = name_scope or type(self).__name__.lower()

    def full_name(self):
        return self._full_name

    # -- creation ------------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A :class:`Parameter` made by :func:`create_parameter` on the
        default device, in ``dtype`` (default: the layer's). It is not
        registered: assign it to an attribute."""
        return create_parameter(
            shape, attr, is_bias=is_bias,
            default_initializer=default_initializer,
            dtype=convert_dtype(dtype) or self._dtype)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """Register ``tensor`` as a buffer; a non-persistable one (Paddle's
        ``persistable=False``, torch's ``persistent=False``) stays out of
        ``state_dict``."""
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)
        return tensor

    # -- traversal -----------------------------------------------------------
    def parameters(self, include_sublayers=True, *, recurse=None):
        """The parameters, each once, in the reference's order (own first,
        then each sublayer's), as a list."""
        return _Listed(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return _Listed(super().buffers(
            include_sublayers if recurse is None else recurse))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self=False):
        """Every sublayer, each once, in pre-order."""
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        """``(structured name, sublayer)`` in pre-order, each layer once
        (``layers_set``: layers to skip, filled as they are met)."""
        for name, layer in self.named_modules(memo=layers_set,
                                              prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def apply(self, fn):
        """``fn(layer)`` for this layer, then each sublayer in pre-order
        (torch's ``apply`` goes children first)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- state ---------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        """Parameters and persistable buffers by structured name (torch's
        ``state_dict``); ``include_sublayers=False`` keeps this layer's
        own, ``structured_name_prefix`` (Paddle's) or ``prefix`` (torch's)
        is put before every name."""
        if structured_name_prefix and not prefix:
            prefix = structured_name_prefix.rstrip(".") + "."
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        out = collections.OrderedDict() if destination is None \
            else destination
        self._save_to_state_dict(out, prefix, keep_vars)
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (tensors or arrays by name) into this layer's
        state; a shape mismatch raises ``ValueError``. Returns ``(missing,
        unexpected)`` names."""
        from ..framework.io_state import set_state_dict

        return set_state_dict(self, state_dict)

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype and device ----------------------------------------------------
    def to(self, *args, **kwargs):
        """Paddle's ``to(device=None, dtype=None, blocking=None)`` (device
        ``"gpu"`` / ``"gpu:N"`` / ``"cpu"``, dtype a Paddle name) and
        torch's forms. A dtype casts the floating parameters and buffers
        and becomes every sublayer's default dtype."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        blocking = kwargs.pop("blocking", None)
        non_blocking = kwargs.pop("non_blocking", False)
        if kwargs:
            raise TypeError(f"to() got unexpected arguments {list(kwargs)}")
        for a in args:
            if isinstance(a, torch.Tensor):
                device, dtype = a.device, a.dtype
            elif isinstance(a, torch.dtype) or a in DTYPES:
                dtype = a
            elif isinstance(a, bool):
                blocking = a
            else:
                device = a
        dtype = convert_dtype(dtype)
        if dtype is not None:
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = dtype
        return super().to(device=_device(device), dtype=dtype,
                          non_blocking=non_blocking or blocking is False)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    def half(self):
        return self.to(dtype=torch.float16)

    # -- hooks and gradients -------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward; a value it
        returns replaces the output. Returns a handle with ``remove()``.
        (``register_forward_pre_hook(hook)``, ``hook(layer, inputs)``, is
        torch's own and has Paddle's convention.)"""
        return self.register_forward_hook(hook)

    def clear_gradients(self, set_to_zero=True):
        """Zero every parameter's gradient (drop it with
        ``set_to_zero=False``)."""
        for p in self.parameters():
            if p.grad is not None:
                if set_to_zero:
                    p.grad.detach_().zero_()
                else:
                    p.grad = None


class Sequential(Layer, nn.Sequential):
    """Layers called in order. Children are named ``"0"``, ``"1"``, ...
    as in the reference (so state names read ``downsample.1._mean``); an
    ``OrderedDict`` or ``(name, layer)`` tuples name them instead."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            layers = tuple(layers[0].items())
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]


class LayerList(Layer, nn.ModuleList):
    """A list of layers named ``"0"``, ``"1"``, ... (the reference's
    ``LayerList``; ``torch.nn.ModuleList`` names and renumbers alike)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


class ParameterList(Layer, nn.ParameterList):
    """A list of parameters named ``"0"``, ``"1"``, ... (reference
    ``ParameterList``)."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.extend(parameters)


class LayerDict(Layer, nn.ModuleDict):
    """An ordered dict of sublayers (reference ``LayerDict``): ``pop``,
    ``clear``, ``update``, ``keys`` / ``values`` / ``items``."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)


__all__ = ["Layer", "LayerDict", "LayerList", "ParamAttr", "Parameter",
           "ParameterList", "Sequential", "create_parameter"]
