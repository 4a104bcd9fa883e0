"""ZeRO-3: parameters sharded over the sharding group (counterpart of the
reference's ``shard_model_parameters(fsdp=True)``,
``paddle_tpu/distributed/fleet/__init__.py:209-253``; upstream Paddle's
``GroupShardedStage3``).

The reference places each parameter on ``_extend_with_axis(spec, shape,
"sharding", n)``: its largest dim that ``n`` divides and that mp has not
split (a dim an mp layer marks, ``split_axis``, is taken even at mp degree
1, as the reference's ``dist_spec`` names it there too). A parameter with
no such dim stays replicated. XLA then gathers the full weights where the
program uses them. Here each sharding rank keeps only its slice of such a
parameter (the Parameter object stays, its data cut along that dim), and:

- a module owning sliced parameters gets a class of its own whose
  attribute for each of them gathers the full weight on access while a
  ZeRO-3 forward runs (:func:`forward_scope`: the model's forward, set up
  by hooks on the model; the recomputed forward of ``recompute`` too), so
  every use in the forward (a tied LM head that reads the embedding's
  weight outside the embedding included) sees the full tensor, and
  outside a forward the attribute is the slice;
- the gather is an autograd function whose backward reduce-scatters the
  full gradient over the sharding group, so the slice's gradient leaves
  the backward summed over the sharding ranks (a weight used twice, such
  as a tied one, is gathered once a use and its slice's gradients add);
- autograd does not keep a gathered weight alive until the backward: a
  ``saved_tensors_hooks`` pair packs a tensor that shares a gathered
  weight's storage as a reference to the slice and its view, and unpacks
  it by gathering again. Torch runs only the innermost pair, so this pair
  and a user's (``autograd.saved_tensors_hooks``) compose, whichever is
  inner (:func:`saved_hooks`): the user's pack sees every saved tensor
  but a gathered weight's, whose slice reference passes by.

In a pipeline each stage slices the blocks it holds (the reference's
dim on the stacked ``[L, ...]`` leaf is this one + 1) and the schedule
opens one forward scope a forward op (``pipeline_parallel.run_schedule``).

``fleet.DistTrainStep`` and ``fused_allreduce_gradients`` then sum the
slices' gradients over the ranks holding the same slices (data x sep) and
divide by the data-parallel degree; ``HybridParallelOptimizer`` updates
each slice with slice-shaped moments and sums the slices' squares over the
sharding group for the global-norm clip. ``framework/io_state.py`` reads
and writes full arrays (``gather_full_state`` / ``load_numpy_state`` /
``set_state_dict``).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Optional

import torch

from ... import collective as C

_tls = threading.local()
#: storage address of a gathered weight -> (weakref to it, its slice)
_gathered = {}


class Zero3Spec:
    """A sliced parameter's layout: the dim cut and the sharding group."""

    def __init__(self, dim, group):
        self.dim, self.group = dim, group


def zero3_spec(p) -> Optional[Zero3Spec]:
    return p.__dict__.get("zero3")


def is_zero3_slice(p) -> bool:
    return zero3_spec(p) is not None


def _extend_with_axis(entries, shape, axis_name, axis_size):
    """The reference's ``_extend_with_axis``: ``axis_name`` on the largest
    dim that ``axis_size`` divides and no other axis splits (the first of
    equal ones), unless an entry already names it."""
    entries = list(entries) + [None] * (len(shape) - len(entries))
    if axis_name in entries:
        return entries
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size \
                and entries[i] is None:
            entries[i] = axis_name
            return entries
    return entries


def slice_dim(p, n) -> Optional[int]:
    """The dim ZeRO-3 cuts ``p`` on over ``n`` sharding ranks, or None
    (replicated), chosen on the global shape as the reference does."""
    from ..layers.mpu import _mp_group, is_mp_shard

    shape = list(p.shape)
    entries = [None] * len(shape)
    if is_mp_shard(p):
        entries[p.split_axis] = "mp"
        shape[p.split_axis] *= _mp_group()[1]
    entries = _extend_with_axis(entries, shape, "sharding", n)
    return entries.index("sharding") if "sharding" in entries else None


# ----------------------------------------------------------- forward scope --
def gathering() -> bool:
    """Whether a ZeRO-3 forward runs (attribute access gathers)."""
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def resumed(on: bool):
    """Within: attribute access gathers if ``on`` (the recomputed forward
    of a checkpointed block, run in the backward: its gathers are the
    backward's, counted as ``zero3_regather_bytes``)."""
    if not on or gathering():
        yield
        return
    _tls.depth, _tls.again = 1, True
    try:
        yield
    finally:
        _tls.depth, _tls.again = 0, False


class _Saved:
    __slots__ = ("param", "size", "stride", "offset")

    def __init__(self, param, t):
        self.param = param
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


def _pack(t):
    if not _gathered or not isinstance(t, torch.Tensor) or t.is_sparse:
        return t
    ptr = t.untyped_storage().data_ptr()
    entry = _gathered.get(ptr)
    if entry is None:
        return t
    full = entry[0]()
    if full is None or full.untyped_storage().data_ptr() != ptr:
        return t
    return _Saved(entry[1], t)


def _unpack(x):
    if isinstance(x, _Saved):
        C.counts["zero3_regather"] += 1
        full = _gather(x.param.detach(), zero3_spec(x.param),
                       "zero3_regather_bytes")
        return full.as_strided(x.size, x.stride, x.offset)
    return x


def saved_hooks(user=None):
    """The saved-tensor pack / unpack pair: :func:`_pack` / :func:`_unpack`
    composed with a user's pair ``(pack, unpack)`` (the user's pack takes
    what ``_pack`` returns unless that is a gathered weight's slice
    reference, which ``_unpack`` alone turns back). Outside a ZeRO-3
    forward ``_pack`` returns every tensor as it is."""
    if user is None:
        return _pack, _unpack
    user_pack, user_unpack = user

    def pack(t):
        x = _pack(t)
        return x if isinstance(x, _Saved) else user_pack(x)

    def unpack(x):
        return _unpack(x) if isinstance(x, _Saved) else user_unpack(x)

    return pack, unpack


def user_hooks():
    """The user's ``saved_tensors_hooks`` pairs open on this thread,
    innermost last (``autograd.saved_tensors_hooks`` keeps it)."""
    if not hasattr(_tls, "user_hooks"):
        _tls.user_hooks = []
    return _tls.user_hooks


@contextlib.contextmanager
def forward_scope():
    """Within: a ZeRO-3 forward (see the module docstring)."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    users = user_hooks()
    try:
        with torch.autograd.graph.saved_tensors_hooks(
                *saved_hooks(users[-1] if users else None)):
            yield
    finally:
        _tls.depth -= 1
        if _tls.depth == 0:
            _gathered.clear()


# ------------------------------------------------------------ the collectives
def _gather(shard, spec, counter="zero3_gather_bytes"):
    """The full tensor of a slice (an all-gather over the sharding group
    along the slice's dim); ``collective.counts[counter]`` adds the bytes
    received (the forward's gathers and the backward's, apart)."""
    from ..layers.mpu import _gather_dim

    full = _gather_dim(shard, spec.dim, spec.group)
    C.counts[counter] += (full.numel() - shard.numel()) * full.element_size()
    return full.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec):
        ctx.spec = spec
        if getattr(_tls, "again", False):  # a recomputed forward
            C.counts["zero3_regather"] += 1
            return _gather(shard, spec, "zero3_regather_bytes")
        full = _gather(shard, spec)
        _gathered[full.untyped_storage().data_ptr()] = (weakref.ref(full),
                                                        shard)
        return full

    @staticmethod
    def backward(ctx, g):
        from ..layers.mpu import _reduce_scatter_dim

        spec = ctx.spec
        out = _reduce_scatter_dim(g.contiguous(), spec.dim, spec.group)
        C.counts["zero3_reduce_scatter_bytes"] += \
            (g.numel() - out.numel()) * g.element_size()
        return out, None


class _GatheredParameter:
    """A module class's attribute for a sliced parameter: the full weight
    (gathered, with the reduce-scatter as its backward) inside a ZeRO-3
    forward, the slice elsewhere."""

    def __init__(self, name):
        self.name = name

    def __get__(self, module, owner=None):
        if module is None:
            return self
        p = module._parameters[self.name]
        if p is None or not gathering() or not is_zero3_slice(p):
            return p
        return _Gather.apply(p, zero3_spec(p))


_classes = {}


def _gathering_class(cls, names):
    key = (cls, names)
    if key not in _classes:
        attrs = {n: _GatheredParameter(n) for n in names}
        attrs.update(__module__=cls.__module__, __qualname__=cls.__qualname__,
                     _zero3_base=cls)
        _classes[key] = type(cls.__name__, (cls,), attrs)
    return _classes[key]


# ----------------------------------------------------------------- sharding
def shard_parameters(model, group):
    """Cut every parameter of ``model`` that has a ZeRO-3 dim to this rank's
    slice over ``group`` (the sharding group), in place; give the modules
    owning slices their gathering class and the model the forward scope.
    Expert slices (split over their own axis) stay as they are. Returns
    the model."""
    from ....incubate.moe import is_expert_slice
    from ..layers.mpu import shard_of

    n, r = group.nranks, max(group.rank, 0)
    for m in model.modules():
        names = []
        for name, p in m._parameters.items():
            if p is None or is_expert_slice(p):
                continue
            if not is_zero3_slice(p):
                d = slice_dim(p, n)
                if d is None:
                    continue
                with torch.no_grad():
                    p.data = shard_of(p.data, d, r, n).clone(
                        memory_format=torch.contiguous_format)
                p.__dict__["zero3"] = Zero3Spec(d, group)
            names.append(name)
        if names:
            base = type(m).__dict__.get("_zero3_base", type(m))
            m.__class__ = _gathering_class(base, tuple(sorted(names)))
    if not getattr(model, "_zero3_hooks", False):
        model.register_forward_pre_hook(_enter)
        model.register_forward_hook(_exit, always_call=True)
        model._zero3_hooks = True
    return model


def _enter(module, args):
    stack = module.__dict__.setdefault("_zero3_scopes", [])
    cm = forward_scope()
    cm.__enter__()
    stack.append(cm)


def _exit(module, args, out):
    module.__dict__["_zero3_scopes"].pop().__exit__(None, None, None)


def is_zero3_model(model) -> bool:
    return any(is_zero3_slice(p) for p in model.parameters())


__all__ = ["Zero3Spec", "forward_scope", "gathering", "is_zero3_model",
           "is_zero3_slice", "resumed", "shard_parameters", "slice_dim",
           "zero3_spec"]
