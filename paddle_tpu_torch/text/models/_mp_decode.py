"""The model-parallel side of the decode adapters (``_GPTDecodeAdapter``,
``_LlamaDecodeAdapter``): what one rank of an mp group serves.

Two kinds of model reach the engine at mp > 1, and both end in one layout:

- a whole model with an mp group from ``EngineConfig(mesh=...)`` (the
  reference's API): the rank takes its heads' columns of the q / k / v
  projections, the matching rows of the attention's output projection,
  and its vocab block of the LM head, as views of the whole weights; the
  MLP and the embeddings stay whole on every rank;
- a model built at mp > 1 (``ColumnParallelLinear`` / ``RowParallelLinear``
  / ``VocabParallelEmbedding``): its layers already hold the rank's heads,
  its MLP slices and its vocab block; the MLP's row-parallel output is
  summed over the group, the embedding sums its own lookups.

Either way each rank runs its ``H / mp`` query heads over its ``Hkv / mp``
kv heads (whole GQA groups), the output projection's partial products are
summed over the group before its bias is added once, and the head gives
this rank's vocab block of the logits, ``ceil(V / mp)`` wide (the last
block padded), for the engine to recombine.
"""
from __future__ import annotations

import torch

from ...distributed import collective as C


def block(n: int, world: int, rank: int):
    """Rank ``rank``'s contiguous part of ``n`` units cut ``world`` ways:
    ``(start, stop, width)``, ``width = ceil(n / world)`` (the last part
    may be shorter than ``width``)."""
    width = -(-n // world)
    start = min(rank * width, n)
    return start, min(start + width, n), width


class MpShard:
    """This rank's place in the mp group of the engine (``group`` None:
    one rank) and the collective its partial products need."""

    def __init__(self, group, model_split: bool):
        self.group = group if group is not None and group.nranks > 1 \
            else None
        self.world = 1 if self.group is None else self.group.nranks
        self.rank = 0 if self.group is None else max(self.group.rank, 0)
        #: the model was built at mp > 1: its layers hold shards already
        self.model_split = model_split

    def heads(self, n: int):
        """``(start, stop)`` of this rank's heads among ``n`` (the adapter
        has checked that the degree divides ``n``)."""
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def cols(self, w, n_heads: int, per_head: int):
        """The rank's heads' columns of a whole ``[in, n_heads * per_head]``
        weight (or its ``[n_heads * per_head]`` bias); the weight as it is
        when the model holds shards or at one rank."""
        if w is None or self.model_split or self.world == 1:
            return w
        a, b = self.heads(n_heads)
        return w[..., a * per_head:b * per_head].contiguous()

    def rows(self, w, n_heads: int, per_head: int):
        """The rank's heads' rows of a whole ``[n_heads * per_head, out]``
        weight, as :meth:`cols` does columns."""
        if self.model_split or self.world == 1:
            return w
        a, b = self.heads(n_heads)
        return w[a * per_head:b * per_head]

    def reduce(self, y):
        """The sum of every rank's partial ``y`` over the group (in place:
        ``y`` is a fresh product)."""
        if self.group is not None:
            C.all_reduce(y, group=self.group)
        return y

    def row_linear(self, x, w, bias):
        """``x @ w`` summed over the group, then ``bias`` added once; at
        one rank the plain ``F.linear`` (the bias fused as before)."""
        from ...nn import functional as F

        if self.group is None:
            return F.linear.raw(x, w, bias)
        y = self.reduce(F.linear.raw(x, w))
        return y if bias is None else y + bias

    def vocab(self, vocab_size: int):
        """``(start, stop, width)`` of the rank's vocab block."""
        return block(vocab_size, self.world, self.rank)


def head_logits(hidden, weight, tied: bool, shard: MpShard, vocab: int):
    """This rank's vocab block of the logits ``[..., width]``: ``hidden``
    against a tied ``[V, h]`` embedding (rows) or an ``[h, V]`` head
    (columns), cut to the rank's block of a whole weight, the last block
    padded with zeros to the common width."""
    from ...nn import functional as F

    if not shard.model_split and shard.world > 1:
        a, b, width = shard.vocab(vocab)
        weight = weight[a:b] if tied else weight[:, a:b]
    else:
        width = weight.shape[0] if tied else weight.shape[1]
    out = F.linear.raw(hidden, weight.t() if tied else weight)
    if out.shape[-1] < width:
        out = torch.nn.functional.pad(out, (0, width - out.shape[-1]))
    return out


def resolve_group(adapter_group, engine_group):
    """The mp group the engine serves over: the model's own (built at
    mp > 1) or the one the engine's mesh names; both given, they must be
    one degree."""
    if adapter_group is not None and engine_group is not None and \
            adapter_group.nranks != engine_group.nranks:
        raise ValueError(
            f"the model was built at mp={adapter_group.nranks} but the "
            f"engine's mesh has mp={engine_group.nranks}")
    g = adapter_group if adapter_group is not None else engine_group
    return g if g is not None and g.nranks > 1 else None
