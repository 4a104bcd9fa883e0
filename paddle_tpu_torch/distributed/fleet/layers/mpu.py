"""Tensor-parallel (Megatron) layers (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu.py`` :134-371).

The reference holds each parameter whole, annotated with a placement on
the ``mp`` mesh axis, and XLA inserts the collectives. Here each rank
holds its shard of an mp parameter (``is_distributed``, ``split_axis``)
and the collectives are explicit autograd functions over the model
parallel group, upstream Paddle's and Megatron's conjugate pairs:

- ``_c_identity``: identity forward, all-reduce (sum) backward: the input
  of a column-parallel product;
- ``_mp_allreduce``: all-reduce forward, identity backward: the output of
  a row-parallel product or of the vocab-parallel lookup;
- ``_c_split`` / ``_c_concat``: keep this rank's part of the last dim /
  all-gather it, each the other's backward.

A layer draws its full parameter from the generator given (the same draws
at every mp degree) and keeps its shard, so a model built with one seed
holds the same full weights at any degree. At mp degree 1 every layer is
the plain one (``nn.Linear``, ``nn.Embedding``, ``_parallel_softmax_ce``):
the same ops, the same names and numerics.

With the activation wire on (``distributed/mp_comm.py``: ``mp_comm`` with
a bf16 / int8 ``wire_dtype``) the row-parallel sum, the vocab-parallel
lookup's sum and the column-parallel input's gradient go through the
quantized wire; off, the layers compute exactly what they compute without
it.

``ParallelCrossEntropy`` is the vocab-parallel softmax cross entropy:
all-reduce MAX of the row max, all-reduce SUM of the exp-sum and of the
picked logit, ``ignore_index`` rows 0; its backward is
``softmax - onehot`` on the rank's vocab shard.

The helpers :func:`shard_of` / :func:`full_of` cut a full array to this
rank's shard and all-gather a shard back (``framework/io_state.py`` loads
and gathers whole models through them).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .... import tensor as T
from ....nn import functional as F
from ....nn import initializer as I
from ....nn.functional.loss import _parallel_softmax_ce
from ....nn.layer import Layer, Parameter, create_parameter
from ... import collective as C
from ..topology import get_hybrid_communicate_group


# ------------------------------------------------------------- group helpers
def _mp_group(mp_group=None):
    """(group, world size, rank) of the model-parallel group: the one
    given, else the hybrid group's, else none (degree 1)."""
    if mp_group is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None:
            return None, 1, 0
        mp_group = hcg.get_model_parallel_group()
    return mp_group, mp_group.nranks, max(mp_group.rank, 0)


def _gather_dim(x, dim, group):
    """Every rank's ``x`` concatenated along ``dim``, in group order."""
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((group.nranks * xs.shape[0],) + xs.shape[1:])
    C.all_gather(out, xs, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x, dim, group):
    """The sum over the group, this rank's part of ``dim`` kept."""
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // group.nranks,) + xs.shape[1:])
    C.reduce_scatter(out, xs, group=group)
    return out.movedim(0, dim)


def _split_dim(x, dim, group):
    n = x.shape[dim] // group.nranks
    return x.narrow(dim, max(group.rank, 0) * n, n).contiguous()


def _allreduce(x, group):
    out = x.clone(memory_format=torch.contiguous_format)
    C.all_reduce(out, group=group)
    return out


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.group), None


class _MPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _allreduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_dim(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, -1, ctx.group), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return _split_dim(g, -1, ctx.group), None


def _c_identity(x, group):
    return _CIdentity.apply(x, group)


def mp_wire(world_size) -> Optional[str]:
    """The activation wire's dtype (``distributed/mp_comm.py``) when it is
    on and the mp degree above 1, else None (the exact collectives)."""
    if world_size <= 1:
        return None
    from ... import mp_comm

    return mp_comm.resolve_config().act_wire


def _mp_allreduce(x, group):
    return _MPAllReduce.apply(x, group)


def _c_split(x, group):
    return _CSplit.apply(x, group)


def _c_concat(x, group):
    return _CConcat.apply(x, group)


# ---------------------------------------------------------- sharded weights
def shard_of(full, axis, rank, world):
    """Part ``rank`` of ``world`` equal parts of ``full`` (a tensor or an
    array) along ``axis``, a view."""
    if world == 1:
        return full
    if full.shape[axis] % world:
        raise ValueError(f"dim {axis} of shape {tuple(full.shape)} does not "
                         f"divide by the mp degree {world}")
    n = full.shape[axis] // world
    return full[(slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)]


def full_of(shard, axis, group):
    """All mp ranks' shards concatenated along ``axis`` (a collective)."""
    if group is None or group.nranks == 1:
        return shard
    return _gather_dim(shard, axis, group)


def is_mp_shard(p) -> bool:
    """Whether ``p`` was made as an mp layer's split parameter (its own
    ``is_distributed`` attribute: ``torch.Tensor.is_distributed`` is also
    a method, which ``getattr`` would find on any tensor)."""
    return p.__dict__.get("is_distributed", False) is True


def _parameter(shape, attr, axis, group_info, **kw):
    """A parameter of full ``shape`` drawn by ``create_parameter``, then
    cut to this rank's shard along ``axis`` (None: replicated)."""
    p = create_parameter(shape, attr, **kw)
    _, world, rank = group_info
    if axis is not None and world > 1:
        shard = Parameter(shard_of(p.data, axis, rank, world).clone(
            memory_format=torch.contiguous_format), trainable=p.trainable)
        shard.__dict__.update(p.__dict__)
        p = shard
    if axis is not None:
        p.is_distributed = True
        p.split_axis = axis
    return p


class _ParallelLayer(Layer):
    def _setup_group(self, mp_group, dim, what):
        info = _mp_group(mp_group)
        self._group, self.world_size, self.rank = info
        if dim % self.world_size:
            raise ValueError(f"{what} {dim} not divisible by mp degree "
                             f"{self.world_size}")
        return info


class ColumnParallelLinear(_ParallelLayer):
    """``y = x @ W[:, shard]``: the weight ``[in, out]`` split on its output
    dim over mp. ``gather_output`` all-gathers ``y``; otherwise each rank
    keeps its columns. Keyword-only ``device`` / ``dtype`` / ``generator``
    / ``weight_init`` / ``bias_attr`` as ``nn.Linear`` takes them; the
    default initializer is the reference's XavierNormal."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 weight_init=None, bias_attr=None):
        super().__init__()
        info = self._setup_group(mp_group, out_features, "out_features")
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = _parameter(
            (in_features, out_features), weight_attr, 1, info,
            default_initializer=weight_init or I.XavierNormal(), **kw)
        self.bias = (_parameter((out_features,), bias_attr, 0, info,
                                is_bias=True, **kw)
                     if has_bias and bias_attr is not False else None)

    def _input(self, x):
        wire = mp_wire(self.world_size)
        if wire:
            from ... import mp_comm

            return mp_comm.wire_identity(x, wire, self._group)
        return _c_identity(x, self._group)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(self._input(x), self.weight, self.bias)
        return _c_concat(y, self._group) if self.gather_output else y


class RowParallelLinear(_ParallelLayer):
    """``y = sum over mp of x[shard] @ W[shard, :] + b``: the weight split on
    its input dim; the input is split first unless ``input_is_parallel``;
    the bias (replicated) is added after the all-reduce."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 weight_init=None, bias_attr=None):
        super().__init__()
        info = self._setup_group(mp_group, in_features, "in_features")
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.weight = _parameter(
            (in_features, out_features), weight_attr, 0, info,
            default_initializer=weight_init or I.XavierNormal(), **kw)
        self.bias = (_parameter((out_features,), bias_attr, None, info,
                                is_bias=True, **kw)
                     if has_bias and bias_attr is not False else None)

    def _output(self, y):
        wire = mp_wire(self.world_size)
        if wire:
            from ... import mp_comm

            return mp_comm.wire_allreduce(y, wire, self._group)
        return _mp_allreduce(y, self._group)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _c_split(x, self._group)
        y = self._output(F.linear(x, self.weight))
        return y if self.bias is None else T.add(y, self.bias)


class VocabParallelEmbedding(_ParallelLayer):
    """An embedding table split on its vocab dim over mp: ids outside the
    rank's range look up 0, and the ranks' rows are all-reduced."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init_std: float = 0.02):
        super().__init__()
        info = self._setup_group(mp_group, num_embeddings, "vocab")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.vocab_start = self.rank * (num_embeddings // self.world_size)
        self.weight = _parameter(
            (num_embeddings, embedding_dim), weight_attr, 0, info,
            default_initializer=I.Normal(0.0, init_std), device=device,
            dtype=dtype, generator=generator)

    def forward(self, ids):
        if self.world_size == 1:
            return F.embedding(ids, self.weight)
        wire = mp_wire(self.world_size)
        if wire:
            from ... import mp_comm

            return mp_comm.vocab_parallel_embedding(
                self.weight, ids, self.vocab_start, wire, self._group)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.weight.shape[0])
        out = F.embedding(torch.where(outside, 0, local), self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return _mp_allreduce(out, self._group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, ignore_index, group, start):
        m = logits.amax(-1, keepdim=True)
        C.all_reduce(m, C.ReduceOp.MAX, group=group)
        shifted = logits - m
        e = torch.exp(shifted)
        s = e.sum(-1, keepdim=True)
        C.all_reduce(s, group=group)
        ignored = label == ignore_index
        local = label.long() - start
        inside = (local >= 0) & (local < logits.shape[-1]) & ~ignored
        idx = torch.where(inside, local, 0).unsqueeze(-1)
        picked = torch.gather(shifted, -1, idx).squeeze(-1)
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        C.all_reduce(picked, group=group)
        loss = torch.log(s.squeeze(-1)) - picked
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
        ctx.save_for_backward(e, s, idx, inside, ignored)
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside, ignored = ctx.saved_tensors
        grad = e / s
        grad.scatter_add_(-1, idx, -inside.unsqueeze(-1).to(grad.dtype))
        g = torch.where(ignored, torch.zeros_like(g), g)
        return grad * g.unsqueeze(-1), None, None, None, None


def parallel_cross_entropy(logits, label, ignore_index=-100, mp_group=None):
    """Per-token softmax cross entropy of vocab-parallel ``logits
    [..., V / mp]`` against global class ids ``label [...]``; 0 where
    ``label == ignore_index``. At mp degree 1, ``_parallel_softmax_ce``."""
    group, world, rank = _mp_group(mp_group)
    if world == 1:
        return _parallel_softmax_ce(logits, label, ignore_index)
    return _VocabParallelCE.apply(logits, label, ignore_index, group,
                                  rank * logits.shape[-1])


class ParallelCrossEntropy(Layer):
    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._mp_group_arg = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return parallel_cross_entropy(input, label, self.ignore_index,
                                      self._mp_group_arg)


# --------------------------------------------------------------- RNG tracker
class RNGStatesTracker:
    """Named random streams (upstream ``mpu/random.py``): inside
    ``rng_state(name)`` the default generators (the CPU's and the current
    CUDA device's) draw from the stream ``name``, which resumes where it
    left off. Megatron seeds ``"local_seed"`` per mp rank, so dropout on
    sharded activations differs by shard while ``"global_seed"`` draws
    alike on every rank."""

    def __init__(self):
        self._states = {}

    def add(self, name: str, seed: int):
        if name in self._states:
            raise ValueError(f"seed name {name} already added")
        with _forked():
            torch.manual_seed(int(seed))
            self._states[name] = _capture()

    def get_states_tracker(self):
        return dict(self._states)

    def set_states_tracker(self, states):
        self._states = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel_rng"):
        if name not in self._states:
            raise ValueError(f"seed name {name} was not added")
        with _forked():
            _restore(self._states[name])
            try:
                yield
            finally:
                self._states[name] = _capture()


def _capture():
    return (torch.get_rng_state(), torch.cuda.get_rng_state()
            if torch.cuda.is_available() else None)


def _restore(state):
    torch.set_rng_state(state[0])
    if state[1] is not None:
        torch.cuda.set_rng_state(state[1])


@contextlib.contextmanager
def _forked():
    saved = _capture()
    try:
        yield
    finally:
        _restore(saved)


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 0):
    """Reset the tracker: ``"global_seed"`` from ``seed``, ``"local_seed"``
    from ``seed + 1024 + mp rank``, and the default generators from
    ``seed``."""
    global _tracker
    _, _, rank = _mp_group()
    _tracker = RNGStatesTracker()
    _tracker.add("global_seed", seed)
    _tracker.add("local_seed", seed + 1024 + rank)
    torch.manual_seed(seed)


__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "RowParallelLinear", "VocabParallelEmbedding", "full_of",
           "get_rng_state_tracker", "is_mp_shard",
           "model_parallel_random_seed", "mp_wire",
           "parallel_cross_entropy", "shard_of"]
