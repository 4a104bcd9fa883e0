"""Megatron sequence parallelism (counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``).

Outside attention and the MLP the activations of an mp group are split
along the sequence (``axis``, 1 for the models' ``[b, t, h]``), and
explicit autograd ops move between the layouts:

- ``ScatterOp``: keep this rank's part of the sequence / all-gather back;
- ``GatherOp``: all-gather the sequence / keep this rank's part back;
- ``AllGatherOp``: all-gather the sequence / reduce-scatter back (the input
  of a column-parallel product: the backward sums the ranks' partial
  input gradients);
- ``ReduceScatterOp``: reduce-scatter / all-gather back (the output of a
  row-parallel product).

``ColumnSequenceParallelLinear`` / ``RowSequenceParallelLinear`` are the
mp linears with those ops at their ends (upstream Paddle's classes). A
parameter that sees only the local sequence (the norms, the row linears'
biases) is marked with :func:`mark_as_sequence_parallel_parameter`: its
gradient is summed over the mp group, by ``fleet.DistTrainStep`` or by the
hooks :func:`register_sequence_parallel_allreduce_hooks` adds for an
eager loop. At mp degree 1 every op is the identity.

The ``sep`` (Ulysses) helpers move between the sequence split over the
sep group and a split of the heads: :func:`sep_reshard_to_heads` takes
``[b, s/sep, h, d]`` to ``[b, s, h/sep, d]`` and
:func:`sep_reshard_to_sequence` back, each an all-to-all over the sep
group whose backward is the other. At sep degree 1 both are the identity.
"""
from __future__ import annotations

import torch

from ..layers import mpu
from ..layers.mpu import (_gather_dim, _mp_group, _reduce_scatter_dim,
                          _split_dim)


def _group():
    group, world, _ = _mp_group()
    return group if world > 1 else None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _split_dim(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.axis, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather_dim(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _split_dim(g, ctx.axis, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather_dim(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.axis, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _reduce_scatter_dim(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.axis, ctx.group), None, None


def _apply(fn, x, axis, group):
    group = group or _group()
    if group is None or group.nranks == 1:
        return x
    if fn in (_Scatter, _ReduceScatter) and x.shape[axis] % group.nranks:
        raise ValueError(
            f"sequence parallel: dim {axis} of {tuple(x.shape)} does not "
            f"divide by the mp degree {group.nranks}")
    return fn.apply(x, axis, group)


class ScatterOp:
    @staticmethod
    def apply(x, axis=1, group=None):
        return _apply(_Scatter, x, axis, group)


class GatherOp:
    @staticmethod
    def apply(x, axis=1, group=None):
        return _apply(_Gather, x, axis, group)


class AllGatherOp:
    @staticmethod
    def apply(x, axis=1, group=None):
        return _apply(_AllGather, x, axis, group)


class ReduceScatterOp:
    @staticmethod
    def apply(x, axis=1, group=None):
        return _apply(_ReduceScatter, x, axis, group)


def scatter(x, axis=1):
    return ScatterOp.apply(x, axis)


def all_gather(x, axis=1):
    return GatherOp.apply(x, axis)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return getattr(parameter, "sequence_parallel", False)


def allreduce_sequence_parallel_grads(params, grads=None):
    """Sum over the mp group the gradients of the sequence-parallel
    parameters among ``params`` (their ``.grad``, or the matching entries
    of ``grads``, in place), in one flat buffer. Parameters whose hooks do
    this already are skipped."""
    group = _group()
    if group is None:
        return
    grads = [p.grad for p in params] if grads is None else grads
    sel = [g for p, g in zip(params, grads)
           if g is not None and is_sequence_parallel_parameter(p)
           and not getattr(p, "_sp_allreduce_hook", False)]
    if not sel:
        return
    flat = torch.cat([g.reshape(-1) for g in sel])
    from ... import collective as C

    C.all_reduce(flat, group=group)
    off = 0
    for g in sel:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False):
    """Sum each sequence-parallel parameter's gradient over the mp group as
    autograd produces it (a tensor hook, so ``backward`` and
    ``autograd.grad`` both see the sum). ``accumulation_steps`` and
    ``fuse`` are accepted for upstream's signature."""
    group = _group()
    if group is None:
        return model
    from ... import collective as C

    def hook(g):
        g = g.clone()
        C.all_reduce(g, group=group)
        return g

    for p in model.parameters():
        if is_sequence_parallel_parameter(p) and \
                not getattr(p, "_sp_allreduce_hook", False):
            p.register_hook(hook)
            p._sp_allreduce_hook = True
    return model


class ColumnSequenceParallelLinear(mpu.ColumnParallelLinear):
    """A column-parallel linear whose input is split along the sequence:
    all-gathered before the product, the gradient reduce-scattered back."""

    def __init__(self, *args, gather_output=False, **kw):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its output "
                             "split (gather_output=False)")
        super().__init__(*args, gather_output=False, **kw)

    def _input(self, x):
        _no_wire(self.world_size)
        return AllGatherOp.apply(x, 1, self._group)


class RowSequenceParallelLinear(mpu.RowParallelLinear):
    """A row-parallel linear whose output is reduce-scattered along the
    sequence; its bias sees the local sequence only (marked)."""

    def __init__(self, *args, input_is_parallel=True, **kw):
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear takes a parallel "
                             "input (input_is_parallel=True)")
        super().__init__(*args, input_is_parallel=True, **kw)
        if self.bias is not None and self.world_size > 1:
            mark_as_sequence_parallel_parameter(self.bias)

    def _output(self, y):
        _no_wire(self.world_size)
        return ReduceScatterOp.apply(y, 1, self._group)


def _no_wire(world_size):
    """The activation wire does not cover the sequence-parallel
    collectives yet: raise rather than run them exact unasked."""
    if mpu.mp_wire(world_size):
        raise NotImplementedError(
            "mp_comm's quantized wire with sequence_parallel is not ported "
            "yet, see ROADMAP.md §A.7 item 3")


def sequence_parallel_on(flag) -> bool:
    """Whether a model asking for sequence parallelism (``flag``) gets it:
    only at mp > 1, as in the reference."""
    return bool(flag) and _group() is not None


def parallel_linear(kind, n_in, n_out, sequence_parallel=False, **kw):
    """A model's column (``kind`` "col", output kept split) or row ("row",
    input already split) parallel linear; the sequence-parallel one when
    :func:`sequence_parallel_on`. ``kw`` as the mp linears take it."""
    sp = sequence_parallel_on(sequence_parallel)
    if kind == "col":
        cls = ColumnSequenceParallelLinear if sp else \
            mpu.ColumnParallelLinear
        return cls(n_in, n_out, gather_output=False, **kw)
    cls = RowSequenceParallelLinear if sp else mpu.RowParallelLinear
    return cls(n_in, n_out, input_is_parallel=True, **kw)


def tied_head_input(hidden, embedding, sequence_parallel):
    """``hidden`` as an LM head tied to a ``VocabParallelEmbedding`` takes
    it at mp > 1: all-gathered along the sequence (its gradient
    reduce-scattered) when ``sequence_parallel`` is on, else passed with
    its gradient summed over mp (each rank's vocab shard contributes;
    through the activation wire when it is on)."""
    if embedding.world_size == 1:
        return hidden
    if sequence_parallel:
        _no_wire(embedding.world_size)
        return AllGatherOp.apply(hidden, 1, embedding._group)
    wire = mpu.mp_wire(embedding.world_size)
    if wire:  # the gradient's sum through the activation wire
        from ... import mp_comm

        return mp_comm.wire_identity(hidden, wire, embedding._group)
    return mpu._c_identity(hidden, embedding._group)


def mark_sequence_parallel_layers(sequence_parallel, *layers):
    """Mark every parameter of ``layers`` (a model's norms) as
    sequence-parallel when :func:`sequence_parallel_on`."""
    if sequence_parallel_on(sequence_parallel):
        for layer in layers:
            for p in layer.parameters():
                mark_as_sequence_parallel_parameter(p)


def _sep_group():
    from ..topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_sep_parallel_world_size() == 1:
        return None
    return hcg.get_sep_parallel_group()


def _exchange(x, group, split_axis, concat_axis):
    """Part ``j`` of ``x`` along ``split_axis`` to group rank ``j``; the
    parts received, in rank order, concatenated along ``concat_axis``."""
    from ... import collective as C

    n = group.nranks
    if x.shape[split_axis] % n:
        raise ValueError(f"sep all-to-all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide by the sep "
                         f"degree {n}")
    parts = torch.stack(x.chunk(n, split_axis)).contiguous()
    out = torch.empty_like(parts)
    C.alltoall_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _SepAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None


def sep_reshard_to_heads(x, head_dim_axis=2):
    """``[b, s/sep, h, d]`` (this rank's block of the sequence, dim 1) to
    ``[b, s, h/sep, d]`` (this rank's heads of the whole sequence)."""
    group = _sep_group()
    if group is None:
        return x
    return _SepAllToAll.apply(x, group, head_dim_axis, 1)


def sep_reshard_to_sequence(x, seq_dim=1):
    """The inverse of :func:`sep_reshard_to_heads` (heads on dim 2)."""
    group = _sep_group()
    if group is None:
        return x
    return _SepAllToAll.apply(x, group, seq_dim, 2)

__all__ = ["AllGatherOp", "ColumnSequenceParallelLinear", "GatherOp",
           "ReduceScatterOp", "RowSequenceParallelLinear", "ScatterOp",
           "all_gather", "allreduce_sequence_parallel_grads",
           "is_sequence_parallel_parameter",
           "mark_as_sequence_parallel_parameter",
           "mark_sequence_parallel_layers", "parallel_linear",
           "sequence_parallel_on", "tied_head_input",
           "register_sequence_parallel_allreduce_hooks", "scatter",
           "sep_reshard_to_heads", "sep_reshard_to_sequence"]
