"""``paddle.incubate.nn`` counterparts (``paddle_tpu/incubate/nn.py``):
the expert-choice MoE and the functionals Llama's ops stand on.

``fused_rms_norm``, ``swiglu`` and ``fused_rotary_position_embedding``
are compositions of plain tensor ops, as in the reference (a fusion
upstream, an XLA fusion there); each raises where the reference raises.

Expert-choice MoE (``FusedEcMoe`` / ``fused_ec_moe``):

Each expert picks its top-``C`` tokens by gate score, ``C = max(tokens //
experts, 1)``; the expert FFN runs as batched einsums over ``[E, C, ...]``
and the gate-weighted outputs are added back at the tokens' positions
(a token picked by several experts sums their outputs, an unpicked token
gets zeros). Plain tensor ops (top-k, einsum, ``index_add_``), as in the
reference, where no kernel stands behind it. The activation is looked up
by name as the reference looks it up in ``jax.nn``, whose ``gelu`` is the
tanh form.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.functional.norm import rms_norm
from ..text.models.llama import _apply_rope, _rope_cache

#: act_type -> activation, with the defaults of the ``jax.nn`` function of
#: that name
_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate=True),
    "relu": F.relu,
    "silu": F.silu,
}


def _activation(act_type):
    if act_type not in _ACTS:
        raise ValueError(f"act_type {act_type!r} not supported; expected "
                         f"one of {sorted(_ACTS)}")
    return _ACTS[act_type]


def _fused_ec_moe(x, gate, w1, b1, w2, b2, act, num_experts):
    act_fn = _activation(act)
    b, s, d = x.shape
    n_tok = b * s
    tokens = x.reshape(n_tok, d)
    cap = max(n_tok // num_experts, 1)
    if gate.dim() == 3:
        # functional form: precomputed gate logits [b, s, E]
        scores = torch.softmax(gate.reshape(n_tok, -1), dim=-1)
    else:
        scores = torch.softmax(tokens @ gate, dim=-1)          # [T, E]
    g, idx = torch.topk(scores.T, cap, dim=-1)                  # [E, cap]
    flat_idx = idx.reshape(-1)
    picked = tokens[flat_idx].reshape(num_experts, cap, d)
    h = act_fn(torch.einsum("ecd,edf->ecf", picked, w1) + b1)
    out_e = (torch.einsum("ecf,efd->ecd", h, w2) + b2) * g[..., None]
    out = torch.zeros((n_tok, d), dtype=x.dtype, device=x.device)
    out = out.index_add(0, flat_idx, out_e.reshape(-1, d).to(x.dtype))
    return out.reshape(b, s, d)


class FusedEcMoe(nn.Module):
    """Expert-choice MoE layer (``paddle.incubate.nn.FusedEcMoe``):
    parameters ``gate [hidden, E]``, ``w1 [E, hidden, inter]``, ``b1 [E, 1,
    inter]``, ``w2 [E, inter, hidden]``, ``b2 [E, 1, hidden]``, weights
    XavierNormal and biases 0 as in the reference. ``weight_attr`` /
    ``bias_attr`` are accepted and ignored."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        _activation(act_type)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        self.num_experts = num_experts
        self.hidden_size = hidden_size
        self.act_type = act_type
        init = I.XavierNormal()
        kw = dict(device=dev, dtype=dtype, generator=generator)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev, dtype=dtype))

        self.gate = nn.Parameter(init((hidden_size, num_experts), **kw))
        self.w1 = nn.Parameter(init((num_experts, hidden_size, inter_size),
                                    **kw))
        self.b1 = zeros(num_experts, 1, inter_size)
        self.w2 = nn.Parameter(init((num_experts, inter_size, hidden_size),
                                    **kw))
        self.b2 = zeros(num_experts, 1, hidden_size)

    def forward(self, x):
        return _fused_ec_moe(x, self.gate, self.w1, self.b1, self.w2,
                             self.b2, self.act_type, self.num_experts)


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """Functional form of :class:`FusedEcMoe`; ``gate`` is either the
    ``[hidden, E]`` gate weight or precomputed logits ``[b, s, E]``."""
    return _fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight,
                         bmm1_bias, act_type, bmm0_weight.shape[0])


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, name=None):
    """RMSNorm over the last axis (``F.rms_norm``), plus ``norm_bias``
    when given. Other ``begin_norm_axis`` values raise, as in the
    reference."""
    nd = x.dim()
    if begin_norm_axis % nd != nd - 1:
        raise NotImplementedError(
            "fused_rms_norm: only last-axis normalization is supported "
            f"(begin_norm_axis={begin_norm_axis} on rank-{nd} input)")
    out = rms_norm(x, norm_weight, epsilon=epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return out


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y=None``, ``x`` splits in half on the last
    axis (the Llama MLP gate form)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """RoPE on each given input of ``q`` / ``k`` / ``v`` ``[B, T, H, D]``
    (the reference rotates v too), halves rotated (neox style).
    ``sin`` / ``cos``: ``[1, T, 1, D]``, ``[T, D]`` (duplicated halves) or
    ``[T, D/2]``; without them, the theta 10000 tables. ``position_ids``
    and the interleaved pairing raise, as in the reference."""
    if position_ids is not None:
        raise NotImplementedError(
            "fused_rotary_position_embedding: position_ids offsets are not "
            "supported; slice the sin/cos caches instead")
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "fused_rotary_position_embedding: interleaved (non-neox) pairing "
            "is not supported")
    d = q.shape[-1]
    if cos is None or sin is None:
        c_np, s_np = _rope_cache(q.shape[1], d, 10000.0)
        cos_h = torch.as_tensor(c_np, device=q.device)
        sin_h = torch.as_tensor(s_np, device=q.device)
    else:
        cos_v = cos.reshape(-1, cos.shape[-1])  # [T, D] or [T, D/2]
        sin_v = sin.reshape(-1, sin.shape[-1])
        cos_h = cos_v[:, :d // 2] if cos_v.shape[-1] == d else cos_v
        sin_h = sin_v[:, :d // 2] if sin_v.shape[-1] == d else sin_v
    return tuple(None if t is None else _apply_rope(t, cos_h, sin_h)
                 for t in (q, k, v))


__all__ = ["FusedEcMoe", "fused_ec_moe", "fused_rms_norm",
           "fused_rotary_position_embedding", "swiglu"]
