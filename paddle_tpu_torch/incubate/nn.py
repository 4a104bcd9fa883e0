"""Expert-choice MoE (counterpart of ``FusedEcMoe`` / ``fused_ec_moe`` in
``paddle_tpu/incubate/nn.py``).

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


__all__ = ["FusedEcMoe", "fused_ec_moe"]
