"""paddle.jit (counterpart of ``paddle_tpu/jit/__init__.py``):
``to_static``, ``save`` / ``load`` and the training step.

``to_static`` wraps a Layer's forward, or a function, in a
:class:`TracedLayer`. The reference lifts it into a pure function and
compiles one XLA program per input signature. The port runs the layer's
own forward eagerly on its device, so autograd reaches the layer's
parameters and the flash kernels K1 / K2 run as in any eager call; what it
keeps per signature is a trace of the function on fake tensors (shapes and
dtypes only, no data, no launch). That trace is where a host sync shows:
Python control flow on a tensor's value, ``.numpy()``, ``float(t)``. The
reference converts such control flow with dy2static (``lax.cond`` /
``while_loop``) and falls back to eager execution, with a warning, when
the conversion cannot compile it; the conversion onto ``torch.cond`` /
``while_loop`` is not ported (ROADMAP.md §A.9b), so here the first such
trace makes the callable fall back, with the reference's warning.

``jit.save`` / ``jit.load`` / ``TranslatedLayer`` (``save_load.py``)
export a Layer with ``torch.export`` and serve the program; see there.

``TrainStep(model, loss_fn, optimizer)`` runs one optimizer step per call:
``loss_fn(model, *batch)``, its gradient with respect to the optimizer's
parameters, then ``optimizer.step()``. The reference compiles this into
one XLA program; here it runs eagerly on the device the model lives on. A
batch of placed tensors (``DTensor``s of ``paddle.distributed``, what
``shard_dataloader`` yields) runs on this rank's local blocks: rows split
over a data axis make the loss's batch-coupled reductions count over its
group (``nn.functional.loss.split_batch``), and the optimizer
``parallelize`` / ``to_distributed`` return averages the gradients there.
``repeat`` / ``run_steps`` run several steps (the reference scans them in
one program; here they loop over ``__call__``), the learning rate held as
it is through the window (nothing steps the scheduler inside it).
``cost_analysis`` / ``memory_analysis`` read the reference's compiled XLA
program and are not ported (ROADMAP.md §A.3).
"""
from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework.dtype import NAMES, convert_dtype


class InputSpec:
    """paddle.static.InputSpec: a shape (``None`` or -1 for a dim the
    program takes at any size), a dtype and a name."""

    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype="
                f"{NAMES.get(self.dtype, self.dtype)}, name={self.name})")


def _collect_layers(obj) -> List[torch.nn.Module]:
    """The Layers a callable runs: itself, its bound ``self``, or the
    Layers its closure holds."""
    if isinstance(obj, torch.nn.Module):
        return [obj]
    self_obj = getattr(obj, "__self__", None)
    if isinstance(self_obj, torch.nn.Module):
        return [self_obj]
    layers = []
    for cell in getattr(obj, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if isinstance(v, torch.nn.Module):
            layers.append(v)
    return layers


#: depth of fake-tensor traces in progress: a TracedLayer called inside
#: one runs its function inline
_trace_depth = 0


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.shape, x.dtype.str)
    try:
        hash(x)
    except TypeError:
        return ("object", repr(x))
    return ("static", x)


def _fake_state(mode, layer):
    """The Layer's parameters and buffers as fake tensors, by every name
    (a tied tensor gets one fake under each of its names)."""
    named = list(layer.named_parameters(remove_duplicate=False)) + list(
        layer.named_buffers(remove_duplicate=False))
    return {n: mode.from_tensor(t) for n, t in named}


class TracedLayer:
    """The product of ``to_static``: runs its function eagerly after
    tracing it once per input signature on fake tensors.

    The signature is the reference's: the structure of the arguments, each
    tensor's (and array's) shape, dtype and device, the other arguments'
    values, and the layers' training flags. ``program_cache_size`` counts
    the signatures traced. A trace that fails (a host sync, or anything
    else it cannot follow) makes this callable fall back to plain eager
    calls for good, with a warning."""

    def __init__(self, fn: Callable, layers: Optional[Sequence] = None,
                 full_graph=True):
        self._fn = fn
        self._layers = (list(layers) if layers is not None
                        else _collect_layers(fn))
        self._cache = {}
        self._eager_fallback = False
        functools.update_wrapper(self, fn, updated=[])

    def _key(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        return (spec, tuple(_leaf_key(x) for x in leaves),
                tuple(m.training for m in self._layers))

    def _trace(self, args, kwargs):
        """Run the function on fake copies of its arguments and of its
        layers' parameters and buffers (swapped in for the trace, restored
        after it); returns the output's structure and each output tensor's
        shape and dtype."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.nn.utils.stateless import _reparametrize_module

        global _trace_depth
        leaves, spec = pytree.tree_flatten((args, kwargs))
        _trace_depth += 1
        try:
            with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                    contextlib.ExitStack() as swapped:
                for layer in self._layers:
                    swapped.enter_context(_reparametrize_module(
                        layer, _fake_state(mode, layer)))
                fake = [mode.from_tensor(x) if isinstance(x, torch.Tensor)
                        else x for x in leaves]
                a, k = pytree.tree_unflatten(fake, spec)
                out = self._fn(*a, **k)
                out_leaves, out_spec = pytree.tree_flatten(out)
                return out_spec, tuple(
                    (tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor)
                    else o for o in out_leaves)
        finally:
            _trace_depth -= 1

    def __call__(self, *args, **kwargs):
        if (self._eager_fallback or not _to_static_enabled or _trace_depth
                or torch.compiler.is_exporting()):
            return self._fn(*args, **kwargs)
        key = self._key(args, kwargs)
        if key not in self._cache:
            try:
                self._cache[key] = self._trace(args, kwargs)
            except Exception as e:  # noqa: BLE001 — any trace failure
                self._fall_back(e)
        return self._fn(*args, **kwargs)

    def _fall_back(self, err):
        warnings.warn(
            f"to_static({getattr(self._fn, '__name__', self._fn)!r}): the "
            f"trace stopped at {type(err).__name__}: {err} (a host sync "
            "point such as .numpy(), float() or `if tensor:`, or an op it "
            "cannot follow); falling back to EAGER execution for this "
            "callable. dy2static's conversion of Python control flow on "
            "tensors (torch.cond / while_loop) is not ported, see "
            "ROADMAP.md §A.9b.", stacklevel=3)
        self._eager_fallback = True

    @property
    def program_cache_size(self):
        """Input signatures traced so far (the reference's compiled
        programs)."""
        return len(self._cache)


_to_static_enabled = True


def enable_to_static(enable: bool = True):
    """paddle.jit.enable_to_static: the global switch of ``to_static``;
    off, every TracedLayer calls its function directly."""
    global _to_static_enabled
    _to_static_enabled = bool(enable)


def to_static(function=None, input_spec=None, build_strategy=None,
              full_graph=True, backend=None, **kwargs):
    """paddle.jit.to_static: a decorator, or a call on a Layer (whose
    ``forward`` becomes a :class:`TracedLayer`; the Layer is returned) or
    on a function (returns its :class:`TracedLayer`)."""

    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = TracedLayer(fn.forward, layers=[fn])
            return fn
        return TracedLayer(fn)

    if function is not None:
        return deco(function)
    return deco


def not_to_static(fn=None):
    """paddle.jit.not_to_static: marks a function to run as Python (every
    function does here); returns it."""
    if fn is None:
        return lambda f: f
    return fn


def ignore_module(modules):
    """paddle.jit.ignore_module: accepted; nothing is converted here."""


# debug verbosity (the reference's dy2static knobs), recorded only
_code_level = 0
_verbosity = 0


def set_code_level(level=100, also_to_stdout=False):
    global _code_level
    _code_level = int(level)


def get_code_level():
    return _code_level


def set_verbosity(level=0, also_to_stdout=False):
    global _verbosity
    _verbosity = int(level)


def get_verbosity():
    return _verbosity


from .save_load import TranslatedLayer, load, save  # noqa: E402


class TrainStep:
    """Forward + backward + optimizer update.

    Only the optimizer's parameter list is trained, in its order; other
    parameters of the model are held fixed and get no gradient (the
    reference treats them as buffers). ``__call__`` returns the loss as a
    detached device tensor, with no host sync. ``donate`` (the reference's
    XLA buffer donation) is accepted and recorded: an eager step has no
    buffers to donate."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate=True):
        self._donate = donate
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._params = list(optimizer._parameter_list)

    def __call__(self, *batch):
        trained = [p for p in self._params if p.requires_grad]
        scope = contextlib.nullcontext()
        if any(type(v).__name__ == "DTensor" for v in batch):
            from ..distributed.auto_parallel import local_inputs
            from ..nn.functional.loss import split_batch

            batch, _, group = local_inputs(batch)
            scope = split_batch(group)
        with scope:
            loss = self._loss_fn(self._model, *batch)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        for p, g in zip(trained, grads):
            p.grad = g
        self._opt.step()
        for p in trained:
            p.grad = None
        return loss.detach()

    def repeat(self, n, *batch):
        """``n`` steps on the same batch; the losses as one ``[n]``
        tensor."""
        return torch.stack([self(*batch) for _ in range(int(n))])

    def run_steps(self, *stacked_batch):
        """One step per slice of dim 0 of every batch argument (each must
        have ``n`` of them); the ``[n]`` losses."""
        n = int(stacked_batch[0].shape[0])
        short = [i for i, v in enumerate(stacked_batch)
                 if v.dim() == 0 or v.shape[0] != n]
        if short:
            raise ValueError(
                f"run_steps: batch args {short} have leading axis "
                f"{[tuple(stacked_batch[i].shape)[:1] for i in short]} != "
                f"{n} (every arg must stack one slice per step)")
        return torch.stack([self(*(v[i] for v in stacked_batch))
                            for i in range(n)])

    def cost_analysis(self, *batch):
        raise NotImplementedError(
            "TrainStep.cost_analysis reads a compiled XLA program; not "
            "ported, see ROADMAP.md §A.3")

    def memory_analysis(self, *batch):
        raise NotImplementedError(
            "TrainStep.memory_analysis reads a compiled XLA program; not "
            "ported, see ROADMAP.md §A.3")


__all__ = ["InputSpec", "TracedLayer", "TrainStep", "TranslatedLayer",
           "enable_to_static", "get_code_level", "get_verbosity",
           "ignore_module", "load", "not_to_static", "save",
           "set_code_level", "set_verbosity", "to_static"]
