"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout ``[batch, seq, heads, head_dim]`` as in the reference.
``paged_attention`` routes by the tensors' device: CUDA tensors launch the
hand-written kernel K3, CPU tensors take its plain version.
``scaled_dot_product_attention`` serves the model's full-sequence forward
on the CPU; on the GPU it needs the flash-attention kernel K1, which a
later slice ports.
"""
from __future__ import annotations

import math

import torch

from ...ops import paged_attention as _pa
from ...ops.paged_attention import mask_fill_value

#: the einsum oracle of the reference (``_paged_attention_op``), mirrored
#: line by line — it is the kernel's plain version
_paged_attention_op = _pa.paged_attention_plain


def _sdpa_reference(q, k, v, mask, dropout_p, causal, scale, training):
    # q, k, v: [B, T, H, D]
    qt = q.transpose(1, 2)  # [B, H, T, D]
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * s
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = torch.where(cm, logits, neg_inf)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, neg_inf)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p and training:
        probs = torch.nn.functional.dropout(probs, dropout_p, training=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)  # back to [B, T, H, D]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """paddle.nn.functional.scaled_dot_product_attention parity, layout
    ``[B, T, H, D]``. CPU only in this slice: the GPU route is the
    flash-attention kernel K1, not ported yet."""
    if query.device.type != "cpu":
        raise NotImplementedError("flash-attention kernel K1 not ported yet")
    return _sdpa_reference(query, key, value, attn_mask, float(dropout_p),
                           bool(is_causal), scale, training)


def paged_attention(query, pool_k, pool_v, page_table, start_position,
                    scale=None, k_scales=None, v_scales=None):
    """Multi-token KV-cached attention against a paged cache: ``query``
    ``[S, T, H, D]``; ``pool_k/v`` ``[N, Hkv, page_size, D]`` at their
    stored dtype; ``page_table`` ``[S, max_pages]`` int32;
    ``start_position`` ``[S]`` int32. ``k_scales``/``v_scales``
    (``[N, Hkv, page_size]`` f32, both or neither) mark int8 pools.
    Returns ``[S, T, H, D]`` f32."""
    return _pa.paged_attention(query, pool_k, pool_v, page_table,
                               start_position, scale=scale,
                               k_scales=k_scales, v_scales=v_scales)


__all__ = ["mask_fill_value", "paged_attention",
           "scaled_dot_product_attention"]
