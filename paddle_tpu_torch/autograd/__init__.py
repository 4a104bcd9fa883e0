"""``paddle.autograd`` (counterpart of ``paddle_tpu/autograd/__init__.py``)
on torch's autograd.

- :func:`backward` and :func:`grad` (also ``paddle.grad``): ``grad``
  returns the gradients of ``outputs`` with respect to ``inputs`` and
  leaves every ``.grad`` as it was; an input the outputs do not use raises
  unless ``allow_unused`` (then None). ``create_graph=True`` raises, as the
  reference's does: higher orders go through the functional forms.
- :class:`PyLayer` / :class:`PyLayerContext`: Paddle's custom op on a
  ``torch.autograd.Function`` made once per subclass. ``ctx.saved_tensor()``
  returns what ``ctx.save_for_backward`` took (tensors through torch's
  saved-tensor machinery, so hooks see them). Paddle's backward returns
  one gradient per floating tensor input, in order; torch wants one per
  argument, so the others (ints, flags, integer tensors) get None.
- :func:`vjp`, :func:`jvp`, :class:`Jacobian`, :class:`Hessian` on
  ``torch.func``: ``Jacobian`` / ``Hessian`` compute on first use and index
  as the ``[out, in]`` matrix (all outputs' rows over all inputs' columns;
  batched: ``[B, out, in]`` per sample); :func:`jacobian` of computed
  tensors, one backward per output element; :func:`hessian` of computed
  tensors raises, as the reference's (it needs ``create_graph``).
- :class:`saved_tensors_hooks`: torch's pair for the scope, composed with
  ZeRO-3's own (``sharding_stage3.saved_hooks``) so that inside a ZeRO-3
  forward a gathered weight is still saved as its slice.
"""
from __future__ import annotations

import math

import torch

from ..distributed.fleet.meta_parallel import sharding_stage3 as _z3

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs`` (a tensor or
    a list), without touching any ``.grad``."""
    if create_graph:
        raise NotImplementedError(
            "create_graph=True (higher-order eager autograd) is not "
            "supported, as in the reference; use autograd.vjp / jvp / "
            "Jacobian / Hessian instead")
    single = isinstance(inputs, torch.Tensor)
    ins = [inputs] if single else list(inputs)
    outs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    grads = torch.autograd.grad(outs, ins, grad_outputs,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    if not allow_unused and any(g is None for g in grads):
        raise RuntimeError(
            "One of the differentiated tensors appears unused in the "
            "graph; set allow_unused=True to return None for it.")
    return grads[0] if single else list(grads)


class PyLayerContext:
    """What ``forward`` leaves for ``backward``: ``save_for_backward`` /
    ``saved_tensor`` (tensors kept by the torch function's context, other
    values as they are) and any attribute set on it."""

    def __init__(self, fn_ctx):
        self._fn_ctx = fn_ctx
        self._layout, self._others = [], []

    def save_for_backward(self, *values):
        self._layout = [isinstance(v, torch.Tensor) for v in values]
        self._others = [v for v in values if not isinstance(v, torch.Tensor)]
        self._fn_ctx.save_for_backward(
            *[v for v in values if isinstance(v, torch.Tensor)])

    def saved_tensor(self):
        kept = iter(self._fn_ctx.saved_tensors)
        others = iter(self._others)
        return tuple(next(kept) if t else next(others) for t in self._layout)


def _differentiable(a):
    return isinstance(a, torch.Tensor) and (a.is_floating_point()
                                            or a.is_complex())


def _function_of(layer):
    """The ``torch.autograd.Function`` running PyLayer subclass ``layer``."""
    fn = layer.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(fn_ctx, kwargs, *args):
        ctx = PyLayerContext(fn_ctx)
        fn_ctx.paddle_ctx = ctx
        fn_ctx.slots = [i for i, a in enumerate(args) if _differentiable(a)]
        fn_ctx.n_args = len(args)
        return layer.forward(ctx, *args, **kwargs)

    def backward(fn_ctx, *grads):
        got = layer.backward(fn_ctx.paddle_ctx, *grads)
        got = [got] if isinstance(got, torch.Tensor) or got is None \
            else list(got)
        out = [None] * (1 + fn_ctx.n_args)
        for slot, g in zip(fn_ctx.slots, got):
            out[1 + slot] = g
        return tuple(out)

    fn = type(f"{layer.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    layer._torch_function = fn
    return fn


class PyLayer:
    """A custom op: subclass with ``@staticmethod forward(ctx, *args,
    **kwargs)`` and ``backward(ctx, *grads)``, call ``apply``. ``forward``
    runs without recording; ``backward`` gets one gradient per output and
    returns one per floating tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)


def _ones_like(out):
    if isinstance(out, tuple):
        return tuple(torch.ones_like(o) for o in out)
    return torch.ones_like(out)


def _as_tuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,)


def vjp(func, xs, v=None):
    """``(func(xs), v^T J)``: ``v`` defaults to ones; ``xs`` a tensor or a
    list (then a list of gradients)."""
    single = isinstance(xs, torch.Tensor)
    vals = _as_tuple(xs)
    out, fn = torch.func.vjp(func, *vals)
    if v is None:
        ct = _ones_like(out)
    elif isinstance(out, tuple):
        ct = tuple(torch.as_tensor(c, dtype=o.dtype, device=o.device)
                   for c, o in zip(_as_tuple(v), out))
    else:
        ct = torch.as_tensor(v, dtype=out.dtype, device=out.device)
    grads = fn(ct)
    return out, (grads[0] if single else list(grads))


def jvp(func, xs, v=None):
    """``(func(xs), J v)``: ``v`` defaults to ones."""
    vals = _as_tuple(xs)
    tangents = (tuple(torch.ones_like(x) for x in vals) if v is None
                else _as_tuple(v))
    return torch.func.jvp(func, vals, tangents)


def _size(shape):
    return math.prod(shape) if len(shape) else 1


class Jacobian:
    """The Jacobian of ``func`` at ``xs`` as the ``[out, in]`` block matrix
    of every output over every input (batched: ``[B, out, in]`` of each
    sample, one input), computed on first use."""

    def __init__(self, func, xs, is_batched=False):
        self._func, self._vals = func, _as_tuple(xs)
        self._is_batched = is_batched
        if is_batched and len(self._vals) != 1:
            raise NotImplementedError("batched Jacobian supports one input")
        self._mat = None

    def _compute(self):
        func, vals = self._func, self._vals
        if self._is_batched:
            x = vals[0]
            jac = torch.func.vmap(torch.func.jacrev(
                lambda v: func(v[None])[0]))(x)
            out_nd = jac.dim() - x[0].dim() - 1
            return jac.reshape(jac.shape[0],
                               _size(jac.shape[1:1 + out_nd]),
                               _size(jac.shape[1 + out_nd:]))
        jac = torch.func.jacrev(func, argnums=tuple(range(len(vals))))(*vals)
        outs = func(*vals)
        multi = isinstance(outs, tuple)
        blocks = jac if multi else (jac,)
        outs = outs if multi else (outs,)
        rows = []
        for out, per_in in zip(outs, blocks):
            n = _size(out.shape)
            rows.append(torch.cat([b.reshape(n, _size(x.shape))
                                   for b, x in zip(per_in, vals)], dim=1))
        return torch.cat(rows, dim=0).detach()

    @property
    def matrix(self) -> torch.Tensor:
        if self._mat is None:
            self._mat = self._compute()
        return self._mat

    def __getitem__(self, idx):
        return self.matrix[idx]

    @property
    def shape(self):
        return list(self.matrix.shape)


class Hessian:
    """The Hessian of a scalar ``func`` at one input as ``[n, n]`` (batched:
    ``[B, n, n]`` of each sample), computed on first use."""

    def __init__(self, func, xs, is_batched=False):
        if not isinstance(xs, torch.Tensor):
            xs = list(xs)
            if len(xs) != 1:
                raise NotImplementedError(
                    "Hessian over multiple inputs is not supported; "
                    "concatenate them into one flat input")
            xs = xs[0]
        self._func, self._x, self._is_batched = func, xs, is_batched
        self._mat = None

    def _compute(self):
        func, x = self._func, self._x
        if self._is_batched:
            h = torch.func.vmap(torch.func.hessian(
                lambda v: func(v[None]).reshape(())))(x)
            n = _size(x.shape[1:])
            return h.reshape(h.shape[0], n, n).detach()
        h = torch.func.hessian(lambda v: func(v).reshape(()))(x)
        n = _size(x.shape)
        return h.reshape(n, n).detach()

    @property
    def matrix(self) -> torch.Tensor:
        if self._mat is None:
            self._mat = self._compute()
        return self._mat

    def __getitem__(self, idx):
        return self.matrix[idx]

    @property
    def shape(self):
        return list(self.matrix.shape)


class saved_tensors_hooks:
    """``pack_hook`` / ``unpack_hook`` around the tensors autograd saves for
    the backward within the scope (torch's pair, composed with ZeRO-3's:
    see the module docstring)."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook
        self._scope = None

    def __enter__(self):
        pair = (self.pack_hook, self.unpack_hook)
        self._scope = torch.autograd.graph.saved_tensors_hooks(
            *_z3.saved_hooks(pair))
        self._scope.__enter__()
        _z3.user_hooks().append(pair)
        return self

    def __exit__(self, *exc):
        _z3.user_hooks().pop()
        self._scope.__exit__(*exc)
        return False


def jacobian(ys, xs, batch_axis=None):
    """The Jacobian of the computed tensor ``ys`` with respect to ``xs`` (a
    tensor or a list): ``[ys.numel(), x.numel()]`` for each input, one
    backward per element of ``ys`` (an unused input's rows are zeros)."""
    single = isinstance(xs, torch.Tensor)
    ins = [xs] if single else list(xs)
    y_flat = ys.reshape(-1)
    n = y_flat.shape[0]
    rows = []
    for i in range(n):
        gs = grad([y_flat[i]], ins, retain_graph=True, allow_unused=True)
        rows.append([torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
                     if g is None else g.reshape(-1)
                     for g, x in zip(gs, ins)])
    outs = []
    for k in range(len(ins)):
        J = torch.stack([r[k] for r in rows])
        if batch_axis is not None:
            b = ys.shape[0]
            J = J.reshape(n // b * b, -1)
        outs.append(J)
    return outs[0] if single else outs


def hessian(ys, xs, batch_axis=None):
    """Raises, as the reference's: the Hessian of a computed tensor needs
    ``create_graph``. Use ``Hessian(func, xs)``."""
    raise NotImplementedError(
        "hessian(ys, xs) needs eager create_graph; use the functional "
        "autograd.Hessian(func, xs) / vjp + jvp instead")


__all__ = ["Hessian", "Jacobian", "PyLayer", "PyLayerContext", "backward",
           "enable_grad", "grad", "hessian", "is_grad_enabled", "jacobian",
           "jvp", "no_grad", "saved_tensors_hooks", "set_grad_enabled",
           "vjp"]
