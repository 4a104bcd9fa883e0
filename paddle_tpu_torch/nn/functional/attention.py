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

Under a sequence split (``ring_attention.sequence_split``: ``fleet.
DistTrainStep`` at ``sep_degree > 1``) both routes run as the ring over the
sep group: the flash route on the kernels, the dense route on the ring's
plain version, each under a mask or bias in the layouts
``ring_attention.split_bias`` names; attention dropout there runs on the
plain ring, as the unsplit route runs it on the dense version.

While a trace records the call (``torch.export`` through ``jit.save``, or
``jit.to_static``'s trace on fake tensors), both routes at dropout 0 call
``ops/library.py::attention`` instead, which a loaded program runs as K1
on the card; the ring refuses to be recorded.
"""
from __future__ import annotations

import math

import torch

from ...framework.op import amp_op
from ...ops import flash_attention as _fa
from ...ops import library as _library
from ...ops import paged_attention as _pa
from ...ops.paged_attention import mask_fill_value
from . import ring_attention as _ring

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
    if _ring.split_group() is not None:
        return _ring_route(q, k, v, mask, dropout_p, causal, scale, training,
                           flash=False)
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


def _ring_route(q, k, v, mask, dropout_p, causal, scale, training, flash):
    """Attention over the split sequence: the ring (the kernels' route when
    ``flash`` and no dropout, else its plain version), the mask never
    differentiated."""
    if mask is not None and mask.dtype != torch.bool:
        mask = mask.detach()
    p = float(dropout_p) if training else 0.0
    return _ring.ring_attention(q, k, v, causal, scale, flash, mask=mask,
                                dropout_p=p)


def _flash(q, k, v, mask, causal, scale):
    """The flash route at dropout 0: K1 / K2 on CUDA tensors (or a
    raise), their plain versions on CPU tensors; a float mask is an
    additive bias that takes no gradient."""
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


def _attend_cpu(q, k, v, mask, causal, scale):
    """What an eager call at dropout 0 runs on CPU tensors: the dense
    ``_sdpa_reference``, or the kernels' plain versions under
    ``_FLASH_ON_CPU``. The CPU body of ``ops/library.py::attention``."""
    if _FLASH_ON_CPU:
        return _flash(q, k, v, mask, causal, scale)
    return _sdpa_reference(q, k, v, mask, 0.0, causal, scale, False)


def _record(q, dropout_p):
    """True when a trace is recording this call (``ops/library.py::
    recording``) and the recorded op serves it: dropout 0, no sequence
    split (which refuses to be recorded)."""
    if not _library.recording(q):
        return False
    if _ring.split_group() is not None:
        raise NotImplementedError(
            "exporting attention under a sequence split (the ring over the "
            "sep group) is not ported, see ROADMAP.md §A.9b")
    return dropout_p == 0.0


@amp_op("sdpa_op", "white", uncast=("raw_mask",))
def _sdpa(q, k, v, mask, dropout_p, causal, scale, training, raw_mask=None):
    if raw_mask is not None:
        mask = raw_mask
    if mask is not None and mask.dtype != torch.bool:
        # mask semantics on every route: a float mask is never
        # differentiated
        mask = mask.detach()
    if _record(q, dropout_p):
        return _library.attention(q, k, v, mask, causal, scale)
    if _ring.split_group() is not None:
        return _ring_route(q, k, v, mask, dropout_p, causal, scale, training,
                           flash=_fa._is_cuda(q) or _FLASH_ON_CPU)
    flash = _fa._is_cuda(q) or _FLASH_ON_CPU  # other devices raise
    if flash and dropout_p == 0.0:
        return _flash(q, k, v, mask, causal, scale)
    return _sdpa_reference(q, k, v, mask, dropout_p, causal, scale, training)


@amp_op("sdpa_op", "white", uncast=("raw_mask",))
def _sdpa_dense(q, k, v, mask, dropout_p, causal, scale, training,
                raw_mask=None):
    """The dense route on every device, for a model built with
    ``use_flash_attention=False``; cast as ``sdpa_op`` like the flash
    route. A recorded trace holds the op of ``ops/library.py`` as the
    flash route's does."""
    if raw_mask is not None:
        mask = raw_mask
    if _record(q, dropout_p):
        return _library.attention(q, k, v, mask, causal, scale)
    return _sdpa_reference(q, k, v, mask, dropout_p, causal, scale, training)


def padded_attention(query, key, value, mask, dropout_p=0.0, training=True,
                     use_flash=True):
    """The encoders' attention: non-causal, under the additive padding mask
    ``[B, 1, 1, Tk]`` the model builds from its ``attention_mask``, on
    :func:`scaled_dot_product_attention`'s routes (``use_flash=False``: the
    dense route on every device). The reference builds that mask as a raw
    array, outside its Tensor type, so its gateway casts q / k / v and not
    the mask; here the mask passes the gateway uncast too."""
    p = float(dropout_p) if training else 0.0
    op = _sdpa if use_flash else _sdpa_dense
    return op(query, key, value, None, p, False, None, training,
              raw_mask=mask)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
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


@amp_op("decode_attention_op", "white")
def _decode_attention_op(q, ck, cv, cache_position, scale):
    """Single-token decode attention against a slot-indexed cache, the
    reference's einsum line by line (no kernel: it is plain jnp there
    too). q ``[S, 1, H, D]``; ck / cv ``[S, Hkv, T, D]``; keys at
    positions > ``cache_position[s]`` are masked out per slot. GQA-native:
    query head h reads kv head ``h // (H / Hkv)``, no head replication."""
    s_, _, h, d = q.shape
    hkv, t = ck.shape[1], ck.shape[2]
    group = h // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q[:, 0].float().reshape(s_, hkv, group, d)
    logits = torch.einsum("shgd,shtd->shgt", qf, ck.float()) * sc
    mask = torch.arange(t, device=q.device)[None, None, None, :] \
        <= cache_position.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, torch.tensor(
        mask_fill_value(), dtype=logits.dtype, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shgt,shtd->shgd", probs, cv.float())
    return out.reshape(s_, 1, h, d).to(q.dtype)


def decode_attention(query, cache_k, cache_v, cache_position, scale=None,
                     name=None):
    """One-step KV-cached attention for decode: ``query`` ``[S, 1, H, D]``;
    ``cache_k`` / ``cache_v`` ``[S, Hkv, T_max, D]``; ``cache_position``
    ``[S]`` int (each slot's position of the token being decoded; keys
    past it are masked). The default scale is ``1 / sqrt(D)``. Plain torch
    on every device, as the reference's is plain jnp; the model-parallel
    head sharding waits for ROADMAP.md §A.7."""
    return _decode_attention_op(query, cache_k, cache_v, cache_position,
                                scale)


#: the reference's names of the paged-attention implementations: "pallas"
#: is its fused kernel (K3 here), "einsum" its oracle (the plain version)
PAGED_KERNELS = ("auto", "pallas", "einsum")


def paged_attention(query, pool_k, pool_v, page_table, start_position,
                    scale=None, k_scales=None, v_scales=None, kernel=None,
                    name=None):
    """Multi-token KV-cached attention against a paged cache: ``query``
    ``[S, T, H, D]`` f32 or bf16; ``pool_k/v`` ``[N, Hkv, page_size, D]``
    at their stored dtype; ``page_table`` ``[S, max_pages]`` int32;
    ``start_position`` ``[S]`` int32. ``k_scales``/``v_scales``
    (``[N, Hkv, page_size]`` f32, both or neither) mark int8 pools.
    Returns ``[S, T, H, D]`` in ``query``'s dtype.

    ``kernel`` picks the implementation by the reference's names (None is
    ``"auto"``): ``"auto"`` and ``"pallas"`` run K3 on a CUDA tensor and
    its plain version on a CPU tensor; ``"einsum"`` runs the plain
    version, on a CPU tensor only: on a CUDA tensor the port launches K3
    or raises, it never takes the plain version there."""
    choice = "auto" if kernel is None else str(kernel).lower()
    if choice not in PAGED_KERNELS:
        raise ValueError(f"unknown attention kernel {kernel!r}; expected one "
                         f"of {PAGED_KERNELS}")
    if choice == "einsum" and query.device.type != "cpu":
        raise ValueError(
            f"kernel='einsum' (the plain version) on a {query.device.type} "
            "tensor: the port runs K3 there")
    return _pa.paged_attention(query, pool_k, pool_v, page_table,
                               start_position, scale=scale,
                               k_scales=k_scales, v_scales=v_scales)


__all__ = ["decode_attention", "flash_attention", "mask_fill_value",
           "padded_attention", "paged_attention",
           "scaled_dot_product_attention"]
