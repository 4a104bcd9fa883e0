"""Mixture-of-Experts layer (counterpart of ``paddle_tpu/incubate/moe.py``).

``MoELayer`` with the reference's two routings and parameter names
(``gate.weight``, ``gate.bias``, ``w_in``, ``b_in``, ``w_out``, ``b_out``;
expert weights stacked ``[E, ...]``), at expert-parallel degree 1:

- ``drop_tokens=True``: GShard top-k gating with a static capacity; tokens
  over an expert's capacity are dropped. Dispatch and combine are dense
  einsums, as in the reference.
- ``drop_tokens=False``: dropless routing. Token copies are sorted by
  routed expert (a stable sort, so rows keep token order inside a group)
  and both expert projections run as ragged grouped matmuls
  (``ops/grouped_matmul.py``: kernels K4a / K4b on the card) with group
  sizes that stay on the device.

Gumbel noise of the capacity gate in training mode comes from the layer's
explicit ``torch.Generator``. ``global_scatter`` / ``global_gather`` (the
token all-to-all of an expert-parallel mesh) belong to the distributed
slice and are not here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layers.common import Linear
from ..ops.grouped_matmul import grouped_matmul


def _one_hot(idx, n):
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _aux_loss(probs, e, k):
    """GShard load-balancing loss: ``E^2/k * sum_e density_e *
    mean-prob_e`` (the one-hot density carries no gradient)."""
    density = _one_hot(probs.argmax(-1), e).mean(0)
    return (density * probs.mean(0)).sum() * (e * e) / max(k, 1)


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def _gshard_gating(logits, generator, k, capacity, use_aux_noise):
    """Top-k gating with static capacity (GShard / Switch).

    logits ``[G, E]`` (G tokens). Returns (combine ``[G, E, C]`` f32,
    dispatch bool ``[G, E, C]``, aux loss)."""
    g, e = logits.shape
    if use_aux_noise and generator is not None:
        logits = logits + _gumbel(logits.shape, generator,
                                  logits.device) * 0.01
    probs = torch.softmax(logits.float(), dim=-1)

    remaining = probs
    fill = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    masks, gates = [], []
    for _ in range(k):
        onehot = _one_hot(remaining.argmax(-1), e)
        gates.append((probs * onehot).sum(-1))
        # position of each token within its chosen expert's queue
        pos = torch.cumsum(onehot, 0) - 1.0 + fill[None, :].float()
        pos = (pos * onehot).sum(-1).to(torch.int32)
        keep = pos < capacity
        masks.append((onehot, pos, keep))
        fill = fill + onehot.sum(0).to(torch.int32)
        remaining = remaining * (1.0 - onehot)

    aux = _aux_loss(probs, e, k)

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


def _moe_apply(flat, combine, dispatch, w_in, b_in, w_out, b_out, act):
    """Capacity routing: dispatch into ``[E, C, h]`` expert buffers, the
    expert FFN as batched einsums, combine back to tokens."""
    expert_in = torch.einsum("gec,gh->ech", dispatch.to(flat.dtype), flat)
    hidden = act(torch.einsum("ech,ehf->ecf", expert_in, w_in) + b_in)
    expert_out = torch.einsum("ecf,efh->ech", hidden, w_out) + b_out
    return torch.einsum("gec,ech->gh", combine.to(flat.dtype), expert_out)


def _moe_apply_dropless(flat, logits, w_in, b_in, w_out, b_out, act, top_k):
    """Dropless routing over the grouped matmul. Returns (out ``[G, H]``,
    aux loss). Nothing here reads a device value on the host."""
    g, h = flat.shape
    e = w_in.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)              # [G, k]
    gates = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)

    aux = _aux_loss(probs, e, top_k)

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


class MoELayer(nn.Module):
    """GShard-style MoE FFN (``paddle.incubate`` MoELayer parity).

    ``num_experts`` expert FFNs ``act(x @ w_in[e] + b_in[e]) @ w_out[e] +
    b_out[e]`` behind a linear gate. ``last_aux_loss`` holds the weighted
    load-balancing loss of the last forward. Built on ``device`` (default:
    the CUDA card), with weights from ``generator`` (default: a generator
    on that device seeded with ``seed``), which also draws the capacity
    gate's training noise."""

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
        self.w_in = nn.Parameter(init((num_experts, d_model, d_hidden), **kw))
        self.b_in = nn.Parameter(torch.zeros((num_experts, 1, d_hidden),
                                             device=dev, dtype=dtype))
        self.w_out = nn.Parameter(init((num_experts, d_hidden, d_model),
                                       **kw))
        self.b_out = nn.Parameter(torch.zeros((num_experts, 1, d_model),
                                              device=dev, dtype=dtype))
        self.last_aux_loss = None

    def forward(self, x):
        b, t, h = x.shape
        g = b * t
        flat = x.reshape(g, h)
        logits = self.gate(flat)
        if not self.drop_tokens:
            out, aux = _moe_apply_dropless(
                flat, logits, self.w_in, self.b_in, self.w_out, self.b_out,
                self.act, self.top_k)
            self.last_aux_loss = aux * self.aux_loss_weight
            return out.reshape(b, t, h)
        capacity = max(self.top_k, int(math.ceil(
            self.top_k * self.capacity_factor * g / self.num_experts)))
        combine, dispatch, aux = _gshard_gating(
            logits, self._generator if self.training else None, self.top_k,
            capacity, self.training)
        self.last_aux_loss = aux * self.aux_loss_weight
        out = _moe_apply(flat, combine, dispatch, self.w_in, self.b_in,
                         self.w_out, self.b_out, self.act)
        return out.reshape(b, t, h)


__all__ = ["MoELayer"]
