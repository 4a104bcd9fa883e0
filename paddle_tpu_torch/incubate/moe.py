"""Mixture-of-Experts layer (counterpart of ``paddle_tpu/incubate/moe.py``).

``MoELayer`` with the reference's two routings and parameter names
(``gate.weight``, ``gate.bias``, ``w_in``, ``b_in``, ``w_out``, ``b_out``;
expert weights stacked ``[E, ...]``):

- ``drop_tokens=True``: GShard top-k gating with a static capacity; tokens
  over an expert's capacity are dropped. Dispatch and combine are dense
  einsums, as in the reference.
- ``drop_tokens=False``: dropless routing. Token copies are sorted by
  routed expert (a stable sort, so rows keep token order inside a group)
  and both expert projections run as ragged grouped matmuls
  (``ops/grouped_matmul.py``: kernels K4a / K4b on the card) with group
  sizes that stay on the device.

Gumbel noise of the capacity gate in training mode comes from the layer's
explicit ``torch.Generator``.

Under ``auto_cast`` the routing runs in its inputs' dtype at the
reference's cast points, its ops ``moe_gate_dispatch``, ``moe_apply`` and
``moe_apply_dropless`` (on neither list: bf16 at O2): a ``decorate``d O2
layer gates, dispatches and runs its experts in bf16 (K4a / K4b in bf16
on the card on the dropless path); the gate's softmax and the aux loss
stay in f32.

Under ``fleet.DistTrainStep`` each rank holds its share of the batch (its
rows over the data axes, its block of the sequence over sep), while the
reference gates the global batch. The gate here is global too: it reads
the token group from the loss's ``split_batch`` context and the sequence
split from ``ring_attention.sequence_split``, and takes the capacity from
the global token count, each token's queue position from its place in the
global token order (an ``all_gather`` of the per-row counts of each top-k
round), and the aux loss from all-reduced sums of the density and the
probabilities. The training noise is drawn for the global ``[G, E]`` on
every rank, each rank keeping its tokens' rows.

Expert parallelism (the capacity path, ``E`` divisible by the expert
axis's degree): the expert axis is the first of ``sharding``, ``data``,
``sep`` above degree 1, as the reference's ``_expert_axis``. Each of its
ranks holds ``E / n`` experts (its slice of ``w_in``, ``b_in``, ``w_out``,
``b_out``, marked ``expert_axis``); tokens reach their experts' owners and
come back through :func:`global_scatter` / :func:`global_gather`, all-to-
alls over the expert group. When the batch's rows do not divide by the
data degree, ``DistTrainStep`` leaves them whole and every rank of the
expert group holds the same tokens: then no exchange runs, each rank
computes its experts on its slots and the outputs are summed over the
group (:func:`_moe_apply_replicated`). Outside ``DistTrainStep`` (an eager loop, or
an evaluation, on each rank's own data) each rank gates its own tokens
and the owners run their experts on each rank's block apart, upstream
Paddle's per-rank semantics; under its split the gate's slots are
disjoint and the owners sum the blocks first. ``state_dict`` gathers the
slices into the full ``[E, ...]`` arrays and loading a full array keeps
the rank's slice, so checkpoints interchange with the reference's (both
are collectives over the expert group). The dropless path keeps every expert, as the
reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed import collective as C
from ..distributed.fleet.topology import get_hybrid_communicate_group
from ..framework.op import amp_op
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.functional import loss as _loss
from ..nn.functional import ring_attention as _ring
from ..nn.layer import Layer
from ..nn.layers.common import Linear
from ..ops.grouped_matmul import grouped_matmul

_EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")


def _expert_group():
    """(axis, group) of the expert axis (the reference's
    ``_expert_axis``), or None without a hybrid group or any axis above
    degree 1."""
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_expert_parallel_axis() is None:
        return None
    return hcg.get_expert_parallel_axis(), hcg.get_expert_parallel_group()


def is_expert_slice(p) -> bool:
    """Whether ``p`` is a rank's slice of stacked expert weights."""
    return p.__dict__.get("expert_axis") is not None


class _TokenLayout:
    """Where this rank's ``[b, t]`` tokens sit in the global batch: the
    token group ``group`` (None: the tokens are the whole batch) of ``D``
    x ``S`` blocks (rows over the data axes, the sequence over the ``sep``
    group; group rank ``d * S + s``) and this rank's block ``(d, s)``;
    ``replica`` a group whose ranks all hold these same tokens (None:
    none known)."""

    def __init__(self, group=None, sep=None, replica=None):
        self.group = group
        self.replica = replica
        self.S = 1 if sep is None else sep.nranks
        r, n = (0, 1) if group is None else (group.rank, group.nranks)
        self.n, self.D = n, n // self.S
        self.d, self.s = divmod(r, self.S)

    @classmethod
    def current(cls):
        """The split that ``fleet.DistTrainStep`` has in force."""
        return cls(_loss._split_group, _ring.split_group(),
                   _loss._replica_group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents too (each
    rank's loss holds the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        C.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        C.all_reduce(g, group=ctx.group)
        return g, None


def _global_sum(x, layout):
    return x if layout.group is None else _AllReduceSum.apply(x, layout.group)


def _one_hot(idx, n):
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _aux_loss(probs, e, k, layout):
    """GShard load-balancing loss over the global tokens: ``E^2/k *
    sum_e density_e * mean-prob_e`` (the one-hot density carries no
    gradient). ``probs`` ``[..., E]`` are this rank's tokens'."""
    flat = probs.reshape(-1, e)
    g = flat.shape[0] * layout.n
    density = _global_sum(_one_hot(flat.argmax(-1), e).sum(0).detach(),
                          layout) / g
    mean = _global_sum(flat.sum(0), layout) / g
    return (density * mean).sum() * (e * e) / max(k, 1)


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def _noise(b, t, e, generator, device, layout):
    """This rank's ``[b, t, E]`` rows of the global batch's Gumbel noise,
    drawn whole on every rank."""
    full = _gumbel((layout.D * b * layout.S * t, e), generator, device)
    full = full.reshape(layout.D * b, layout.S * t, e)
    return full[layout.d * b:(layout.d + 1) * b,
                layout.s * t:(layout.s + 1) * t]


def _queue_offsets(rows, layout):
    """``(offset [k, b, E], fill [k, E])`` from this rank's per-row counts
    ``rows [k, b, E]`` of each top-k round: the tokens before this rank's
    row ``b`` in the global token order (data blocks, then rows, then the
    row's sep blocks) that chose each expert in the same round, and the
    global totals of the earlier rounds."""
    if layout.group is None:
        cnt = rows[None, None]
    else:
        parts = C.all_gather(None, rows.contiguous(), group=layout.group)
        cnt = torch.stack(parts).reshape(layout.D, layout.S, *rows.shape)
    per_d = cnt.sum((1, 3))                                      # [D, k, E]
    before_d = (per_d.cumsum(0) - per_d)[layout.d]               # [k, E]
    mine = cnt[layout.d]                                         # [S, k, b, E]
    per_row = mine.sum(0)                                        # [k, b, E]
    before_rows = per_row.cumsum(1) - per_row
    before_s = mine[:layout.s].sum(0)
    total = per_d.sum(0)                                         # [k, E]
    fill = total.cumsum(0) - total
    return before_d[:, None, :] + before_rows + before_s, fill


@amp_op("moe_gate_dispatch")
def _gshard_gating(logits, generator, k, capacity, use_aux_noise,
                   layout=None):
    """Top-k gating with static capacity (GShard / Switch).

    logits ``[b, t, E]`` (this rank's tokens; ``layout`` places them in the
    global batch, default: they are the whole batch). Returns (combine
    ``[b*t, E, C]`` f32, dispatch bool ``[b*t, E, C]``, aux loss)."""
    layout = layout or _TokenLayout()
    b, t, e = logits.shape
    if use_aux_noise and generator is not None:
        logits = logits + _noise(b, t, e, generator, logits.device,
                                 layout) * 0.01
    probs = torch.softmax(logits.float(), dim=-1)

    remaining = probs
    onehots, gates = [], []
    for _ in range(k):
        onehot = _one_hot(remaining.argmax(-1), e)              # [b, t, E]
        gates.append((probs * onehot).sum(-1).reshape(-1))
        onehots.append(onehot)
        remaining = remaining * (1.0 - onehot)
    offset, fill = _queue_offsets(torch.stack([o.sum(1) for o in onehots]),
                                  layout)
    masks = []
    for j, onehot in enumerate(onehots):
        # position of each token within its chosen expert's global queue
        pos = (torch.cumsum(onehot, 1) - 1.0 + offset[j][:, None, :]
               + fill[j])
        pos = (pos * onehot).sum(-1).reshape(-1).to(torch.int32)
        masks.append((onehot.reshape(-1, e), pos, pos < capacity))

    aux = _aux_loss(probs, e, k, layout)

    g = b * t
    denom = sum(gt * m[2] for gt, m in zip(gates, masks)).clamp(min=1e-9)
    dispatch = torch.zeros((g, e, capacity), dtype=torch.bool,
                           device=logits.device)
    combine = torch.zeros((g, e, capacity), dtype=torch.float32,
                          device=logits.device)
    for gt, (onehot, pos, keep) in zip(gates, masks):
        w = (gt / denom) * keep.float()
        sel = onehot.bool() & keep[:, None]
        oh_cap = _one_hot(pos, capacity)                        # [G, C]
        combine = combine + (w[:, None, None] * onehot[:, :, None]
                             * oh_cap[:, None, :])
        dispatch = dispatch | (sel[:, :, None] & (oh_cap[:, None, :] > 0))
    return combine, dispatch, aux


def _ffn(x, w_in, b_in, w_out, b_out, act):
    """The experts' FFN on expert-major buffers ``[E', C, h]``."""
    hidden = act(torch.einsum("ech,ehf->ecf", x, w_in) + b_in)
    return torch.einsum("ecf,efh->ech", hidden, w_out) + b_out


@amp_op("moe_apply")
def _moe_apply(flat, combine, dispatch, w_in, b_in, w_out, b_out, act):
    """Capacity routing: dispatch into ``[E, C, h]`` expert buffers, the
    expert FFN as batched einsums, combine back to tokens."""
    expert_in = torch.einsum("gec,gh->ech", dispatch.to(flat.dtype), flat)
    expert_out = _ffn(expert_in, w_in, b_in, w_out, b_out, act)
    return torch.einsum("gec,ech->gh", combine.to(flat.dtype), expert_out)


@amp_op("moe_apply")
def _moe_apply_ep(flat, combine, dispatch, w_in, b_in, w_out, b_out, act,
                  group, disjoint):
    """Capacity routing with this rank's ``E / n`` experts, upstream
    Paddle's per-rank form: the rank's ``[E, C, h]`` buffer goes to the
    experts' owners (:func:`global_scatter`), each owner runs its experts
    on the ``n`` source blocks it received and sends each block's output
    back to its source (:func:`global_gather`). With ``disjoint`` (one
    gate over the group's tokens gave each rank its own slots of the
    global queues) the owner sums the blocks and runs its experts once,
    and every source gets the same output back."""
    n = group.nranks
    expert_in = torch.einsum("gec,gh->ech", dispatch.to(flat.dtype), flat)
    e, c, h = expert_in.shape
    el = e // n
    x = global_scatter(expert_in, group=group).reshape(n, el, c, h)
    if disjoint:
        x = x.sum(0, keepdim=True)
    m = x.shape[0]
    out = _ffn(x.transpose(0, 1).reshape(el, m * c, h), w_in, b_in, w_out,
               b_out, act)
    out = out.reshape(el, m, c, h).transpose(0, 1).expand(n, el, c, h)
    expert_out = global_gather(out.reshape(e, c, h), group=group)
    return torch.einsum("gec,ech->gh", combine.to(flat.dtype), expert_out)


class _ToExperts(torch.autograd.Function):
    """The identity forward; the backward averages the cotangents over the
    group (see :func:`_moe_apply_replicated`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        C.all_reduce(g, group=ctx.group)
        return g / ctx.group.nranks, None


class _FromExperts(torch.autograd.Function):
    """The sum over the group forward; the backward scales the cotangent
    by the group's size (see :func:`_moe_apply_replicated`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.nranks
        out = x.clone(memory_format=torch.contiguous_format)
        C.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


@amp_op("moe_apply")
def _moe_apply_replicated(flat, combine, dispatch, w_in, b_in, w_out, b_out,
                          act, group):
    """Capacity routing with this rank's ``E / n`` experts when every rank
    of the expert group holds the same tokens (and so the same gate): no
    exchange. Each rank runs its experts on its slots of the dispatch and
    combines their outputs; the partial outputs are summed over the group.

    The backward gives every rank the same input and gate gradients (the
    cotangents reaching ``flat`` and ``combine`` through each rank's
    experts, summed over the group) and each expert slice ``n`` times its
    gradient, the sum over the ``n`` identical source blocks that the
    exchange's backward would bring it, as ``allreduce_gradients``
    expects of an expert slice."""
    n, r = group.nranks, group.rank
    el = w_in.shape[0]
    mine = slice(r * el, (r + 1) * el)
    x = _ToExperts.apply(flat, group)
    comb = _ToExperts.apply(combine, group)
    expert_in = torch.einsum("gec,gh->ech", dispatch[:, mine].to(x.dtype), x)
    expert_out = _ffn(expert_in, w_in, b_in, w_out, b_out, act)
    part = torch.einsum("gec,ech->gh", comb[:, mine].to(x.dtype), expert_out)
    return _FromExperts.apply(part, group) if n > 1 else part


@amp_op("moe_apply_dropless")
def _moe_apply_dropless(flat, logits, w_in, b_in, w_out, b_out, act, top_k,
                        layout=None):
    """Dropless routing over the grouped matmul. Returns (out ``[G, H]``,
    aux loss over the global tokens of ``layout``). Nothing here reads a
    device value on the host."""
    g, h = flat.shape
    e = w_in.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)              # [G, k]
    gates = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)

    aux = _aux_loss(probs, e, top_k, layout or _TokenLayout())

    gk = g * top_k
    expert_ids = topi.reshape(-1)                               # [gk]
    order = torch.argsort(expert_ids, stable=True)  # ties keep token order
    # the reference's bincount(length=e); torch.bincount would read the
    # largest id on the host first
    sizes = torch.zeros((e,), dtype=torch.int32, device=flat.device)
    sizes.scatter_add_(0, expert_ids, torch.ones_like(expert_ids,
                                                      dtype=torch.int32))
    row_gid = expert_ids[order]
    xs = flat[order // top_k]                                   # [gk, H]

    h1 = grouped_matmul(xs, w_in, sizes) + b_in[row_gid, 0]
    a = act(h1).to(flat.dtype)
    y = grouped_matmul(a, w_out, sizes) + b_out[row_gid, 0]

    # unsort the copies back to (token, slot) order: the inverse of order
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(gk, device=order.device))
    y_tok = y[inv].reshape(g, top_k, h)
    out = (gates[..., None].to(flat.dtype) * y_tok).sum(1)
    return out, aux


class MoELayer(Layer):
    """GShard-style MoE FFN (``paddle.incubate`` MoELayer parity).

    ``num_experts`` expert FFNs ``act(x @ w_in[e] + b_in[e]) @ w_out[e] +
    b_out[e]`` behind a linear gate. ``last_aux_loss`` holds the weighted
    load-balancing loss of the last forward. Built on ``device`` (default:
    the CUDA card), with weights from ``generator`` (default: a generator
    on that device seeded with ``seed``), which also draws the capacity
    gate's training noise. Built after ``fleet.init`` with an expert axis
    of degree ``n`` dividing ``num_experts``, the capacity path keeps this
    rank's ``E / n`` experts (the full weights are drawn, then cut, so the
    model is the same at every degree)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 gate: str = "gshard", aux_loss_weight: float = 1e-2,
                 activation=None, drop_tokens: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = 1 if gate == "switch" else top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.act = activation or F.gelu
        self.drop_tokens = drop_tokens
        self._generator = generator
        init = I.XavierNormal()
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.gate = Linear(d_model, num_experts, weight_init=init, **kw)
        w_in = init((num_experts, d_model, d_hidden), **kw)
        b_in = torch.zeros((num_experts, 1, d_hidden), device=dev,
                           dtype=dtype)
        w_out = init((num_experts, d_hidden, d_model), **kw)
        b_out = torch.zeros((num_experts, 1, d_model), device=dev,
                            dtype=dtype)
        ep = _expert_group()
        self._ep = None
        if ep is not None and drop_tokens and \
                num_experts % ep[1].nranks == 0:
            hcg = get_hybrid_communicate_group()
            if hcg.get_pipe_parallel_world_size() > 1:
                raise NotImplementedError(
                    "expert parallelism with pp_degree > 1 (a MoE block in "
                    "a pipeline) is not ported yet, see ROADMAP.md §A.7 "
                    "item 1")
            self._ep = ep
            el = num_experts // ep[1].nranks
            cut = slice(ep[1].rank * el, (ep[1].rank + 1) * el)
            w_in, b_in, w_out, b_out = (x[cut].clone()
                                        for x in (w_in, b_in, w_out, b_out))
        self.w_in = nn.Parameter(w_in)
        self.b_in = nn.Parameter(b_in)
        self.w_out = nn.Parameter(w_out)
        self.b_out = nn.Parameter(b_out)
        if self._ep is not None:
            for name in _EXPERT_LEAVES:
                getattr(self, name).expert_axis = self._ep[0]
        self.last_aux_loss = None

    # -- the full [E, ...] arrays in the state, this rank's slice held ----
    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        if self._ep is None:
            return
        from ..distributed.fleet.layers.mpu import full_of

        for name in _EXPERT_LEAVES:
            destination[prefix + name] = full_of(
                getattr(self, name).detach(), 0, self._ep[1])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self._ep is not None:
            group = self._ep[1]
            for name in _EXPERT_LEAVES:
                v = state_dict.get(prefix + name)
                if v is not None and v.shape[0] == self.num_experts:
                    el = self.num_experts // group.nranks
                    state_dict[prefix + name] = v[group.rank * el:
                                                  (group.rank + 1) * el]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        b, t, h = x.shape
        flat = x.reshape(b * t, h)
        logits = self.gate(flat)
        layout = _TokenLayout.current()
        if not self.drop_tokens:
            out, aux = _moe_apply_dropless(
                flat, logits, self.w_in, self.b_in, self.w_out, self.b_out,
                self.act, self.top_k, layout)
            self.last_aux_loss = aux * self.aux_loss_weight
            return out.reshape(b, t, h)
        g = b * t * layout.n
        capacity = max(self.top_k, int(math.ceil(
            self.top_k * self.capacity_factor * g / self.num_experts)))
        combine, dispatch, aux = _gshard_gating(
            logits.reshape(b, t, -1),
            self._generator if self.training else None, self.top_k,
            capacity, self.training, layout)
        self.last_aux_loss = aux * self.aux_loss_weight
        weights = (self.w_in, self.b_in, self.w_out, self.b_out, self.act)
        if self._ep is None:
            out = _moe_apply(flat, combine, dispatch, *weights)
        else:
            group = self._ep[1]
            ranks = set(group.ranks)
            if layout.group is not None and ranks <= set(layout.group.ranks):
                out = _moe_apply_ep(flat, combine, dispatch, *weights, group,
                                    disjoint=True)
            elif layout.replica is not None and \
                    ranks <= set(layout.replica.ranks):
                out = _moe_apply_replicated(flat, combine, dispatch,
                                            *weights, group)
            elif layout.group is None:
                out = _moe_apply_ep(flat, combine, dispatch, *weights, group,
                                    disjoint=False)
            else:
                raise NotImplementedError(
                    "expert parallelism over an axis that splits some of "
                    "the tokens and not the others, see ROADMAP.md §A.7 "
                    "item 9")
        return out.reshape(b, t, h)


# ------------------------------------------------- global_scatter / gather --
class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 with the split sizes given (None:
    equal parts); the backward is the exchange back. Each call adds its
    input's bytes to ``collective.counts[name + "_bytes"]``."""

    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits, name):
        ctx.group, ctx.splits, ctx.name = group, (in_splits, out_splits), name
        return _all_to_all(x, group, in_splits, out_splits, name)

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        return (_all_to_all(g, ctx.group, out_splits, in_splits, ctx.name),
                None, None, None, None)


def _all_to_all(x, group, in_splits, out_splits, name):
    x = x.contiguous()
    rows = x.shape[0] if out_splits is None else sum(out_splits)
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    C.alltoall_single(out, x, in_splits, out_splits, group=group)
    C.counts[f"{name}_bytes"] += x.numel() * x.element_size()
    return out


def _exchange_group(group):
    if group is not None:
        return group
    ep = _expert_group()
    return None if ep is None else ep[1]


def _count_layout(local_count, global_count, n):
    """Host lists from upstream Paddle's counts: rows sent to each rank,
    rows received from each rank, and the order that takes the received
    rows from (source rank, expert) to (expert, source rank) blocks."""
    lc = [int(v) for v in local_count.reshape(-1).tolist()]
    gc = [int(v) for v in global_count.reshape(-1).tolist()]
    el = len(lc) // n
    send = [sum(lc[j * el:(j + 1) * el]) for j in range(n)]
    recv = [sum(gc[j * el:(j + 1) * el]) for j in range(n)]
    starts, off = {}, 0
    for j in range(n):
        for i in range(el):
            starts[j, i] = off
            off += gc[j * el + i]
    order = [r for i in range(el) for j in range(n)
             for r in range(starts[j, i], starts[j, i] + gc[j * el + i])]
    return send, recv, order


def global_scatter(x, local_count=None, global_count=None, group=None):
    """The token all-to-all to the experts' owners over the expert group
    (``group``: default the hybrid group's expert axis; none or one rank:
    ``x`` as it is).

    Without counts: ``x`` is an expert-major buffer ``[E, ...]`` of this
    rank's tokens, and the result ``[E, ...]`` holds, as ``[n, E / n,
    ...]``, the rows of this rank's experts from each rank of the group.
    With upstream Paddle's counts (``local_count[i]``: rows of ``x``, in
    expert order, for global expert ``i``; ``global_count[i]``: rows this
    rank receives from rank ``i // (E / n)`` for its expert ``i % (E /
    n)``) the rows go by those sizes and arrive grouped by expert, then by
    source rank, as upstream's op leaves them. Differentiable; its bytes
    add to ``collective.counts["global_scatter_bytes"]``."""
    group = _exchange_group(group)
    if group is None or group.nranks == 1:
        return x
    if local_count is None:
        return _AllToAll.apply(x, group, None, None, "global_scatter")
    send, recv, order = _count_layout(local_count, global_count,
                                      group.nranks)
    out = _AllToAll.apply(x, group, send, recv, "global_scatter")
    return out[torch.as_tensor(order, dtype=torch.long, device=x.device)]


def global_gather(x, local_count=None, global_count=None, group=None):
    """The inverse of :func:`global_scatter` with the same arguments: the
    experts' output rows back to the ranks that sent the tokens, in their
    expert-major order. Differentiable; its bytes add to
    ``collective.counts["global_gather_bytes"]``."""
    group = _exchange_group(group)
    if group is None or group.nranks == 1:
        return x
    if local_count is None:
        return _AllToAll.apply(x, group, None, None, "global_gather")
    send, recv, order = _count_layout(local_count, global_count,
                                      group.nranks)
    back = torch.empty(len(order), dtype=torch.long)
    back[torch.as_tensor(order, dtype=torch.long)] = torch.arange(len(order))
    return _AllToAll.apply(x[back.to(x.device)], group, recv, send,
                           "global_gather")


__all__ = ["MoELayer", "global_gather", "global_scatter", "is_expert_slice"]
