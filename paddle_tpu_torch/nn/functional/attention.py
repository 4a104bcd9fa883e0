"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layout ``[batch, seq, heads, head_dim]`` as in the reference.
``paged_attention`` routes by the tensors' device: CUDA tensors launch the
hand-written kernel K3, CPU tensors take its plain version.
``scaled_dot_product_attention`` serves the model's full-sequence forward
and backward: on CUDA tensors through the flash-attention kernels K1 / K2
(``ops/flash_attention.py``), on CPU tensors through the dense
``_sdpa_reference``, as on the reference's CPU. It is the reference's
``sdpa_op``, on the AMP white list: under ``auto_cast`` q / k / v (and a
float mask) arrive in bf16, and K1 / K2 run in bf16.
"""
from __future__ import annotations

import math

import torch

from ...framework.op import amp_op
from ...ops import flash_attention as _fa
from ...ops import paged_attention as _pa
from ...ops.paged_attention import mask_fill_value

#: test hook, the counterpart of the reference's
#: ``PADDLE_TPU_PALLAS_INTERPRET=1``: when True, CPU tensors take the flash
#: route too (the kernels' plain versions through ``FlashAttentionFunction``)
#: instead of ``_sdpa_reference``. Not a user option.
_FLASH_ON_CPU = False

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


@amp_op("sdpa_op", "white")
def _sdpa(q, k, v, mask, dropout_p, causal, scale, training):
    if mask is not None and mask.dtype != torch.bool:
        # mask semantics on every route: a float mask is never
        # differentiated
        mask = mask.detach()
    flash = _fa._is_cuda(q) or _FLASH_ON_CPU  # other devices raise
    if flash and dropout_p == 0.0:
        if mask is not None and mask.dim() < 4:
            mask = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
        if mask is None:
            return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
        if mask.dtype == torch.bool:
            return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                       mask=mask)
        # an additive mask, not a trained bias: the dS pass is skipped
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   bias=mask, bias_needs_grad=False)
    return _sdpa_reference(q, k, v, mask, dropout_p, causal, scale, training)


@amp_op("sdpa_op", "white")
def _sdpa_dense(q, k, v, mask, dropout_p, causal, scale, training):
    """The dense route on every device, for a model built with
    ``use_flash_attention=False``; cast as ``sdpa_op`` like the flash
    route."""
    return _sdpa_reference(q, k, v, mask, dropout_p, causal, scale, training)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """paddle.nn.functional.scaled_dot_product_attention parity, layout
    ``[B, T, H, D]``. ``attn_mask`` (bool keep-mask or additive float mask,
    broadcastable to ``[B, H, Tq, Tk]``) is never differentiated.

    Routes: CUDA tensors with no active dropout go to the flash-attention
    kernels K1 / K2 at every length (the reference's 1024-token gate was
    measured on a TPU and does not carry over). With dropout active
    (``dropout_p > 0`` and ``training``) the dense ``_sdpa_reference``
    runs on every device, as in the reference; the training path runs
    with attention dropout 0. CPU tensors take ``_sdpa_reference``."""
    p = float(dropout_p) if training else 0.0
    return _sdpa(query, key, value, attn_mask, p, bool(is_causal), scale,
                 training)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """paddle.nn.functional.flash_attention parity: ``(out, None)`` with
    ``out`` from :func:`scaled_dot_product_attention`'s route."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


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


__all__ = ["flash_attention", "mask_fill_value", "paged_attention",
           "scaled_dot_product_attention"]
