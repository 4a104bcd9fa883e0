"""``paddle.nn.functional.flash_attention`` (counterpart of
``paddle_tpu/nn/functional/flash_attention.py``): the dense entry points
and :func:`flash_attn_unpadded`, packed variable-length attention.

The packed batch is one token axis ``[T, H, D]`` holding the sequences
back to back, ``cu_seqlens`` their cumulative starts. It runs as one
attention call over ``[1, T, H, D]`` whose keep-mask is block-diagonal by
sequence (segment ids from ``cu_seqlens``), causal within each sequence
when asked (bottom-right aligned where a sequence's q-length differs from
its k-length). Tokens past ``cu_seqlens[-1]`` belong to no sequence and
see nothing. The mask goes to ``ops/flash_attention.py::flash_attention``
as its bias (``bias_needs_grad=False``): on a CUDA tensor that is K1 /
K2a / K2b, which compute every tile of the ``[T, T]`` square (a
segment-aware kernel would skip the tiles no sequence sees: ROADMAP.md
§B.2); on a CPU tensor their plain versions. The reference chooses its
Pallas kernel only from 1024 tokens (a TPU tiling choice); here the
kernels run at every length.

A query row with no visible key (a tail token; a causal row of a sequence
whose q-length exceeds its k-length) returns zeros, and its backward adds
nothing to dK / dV: the kernels' dead-row contract (``lse = NEG_INF``,
``P = 0``), where the reference lets such a row see key 0 and zeroes it
after. Dropout and ``return_softmax`` raise, as in the reference.
"""
from __future__ import annotations

import torch

from ...ops import flash_attention as _fa
from .attention import flash_attention, scaled_dot_product_attention  # noqa: F401

__all__ = ["flash_attention", "flash_attention_with_sparse_mask",
           "flash_attn_unpadded", "scaled_dot_product_attention"]


def _segment_ids(cu_seqlens, total):
    """``cu_seqlens`` ``[n+1]`` -> each token's sequence ``[total]``
    (int64); tokens from ``cu_seqlens[-1]`` on get -1."""
    starts = cu_seqlens[1:-1]
    marks = torch.zeros(total, dtype=torch.int64, device=cu_seqlens.device)
    marks.index_add_(0, starts.clamp(max=total - 1),
                     (starts < total).to(torch.int64))
    seg = torch.cumsum(marks, 0)
    pos = torch.arange(total, device=cu_seqlens.device)
    return torch.where(pos < cu_seqlens[-1], seg, torch.full_like(seg, -1))


def _visible(cu_q, cu_k, tq, tk, causal):
    """The ``[Tq, Tk]`` keep-mask of the packed batch (see the module
    docstring)."""
    seg_q, seg_k = _segment_ids(cu_q, tq), _segment_ids(cu_k, tk)
    vis = (seg_q[:, None] == seg_k[None, :]) & (seg_q[:, None] >= 0)
    if causal:
        sq, sk = seg_q.clamp(min=0), seg_k.clamp(min=0)
        local_q = torch.arange(tq, device=cu_q.device) - cu_q[sq]
        local_k = torch.arange(tk, device=cu_k.device) - cu_k[sk]
        len_q = (cu_q[1:] - cu_q[:-1])[sq]
        len_k = (cu_k[1:] - cu_k[:-1])[sq]
        vis &= local_k[None, :] <= (local_q + (len_k - len_q))[:, None]
    return vis


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Packed (variable-length) attention.

    ``query`` ``[Tq, H, D]``, ``key`` / ``value`` ``[Tk, Hkv, D]``;
    ``cu_seqlens_q`` / ``cu_seqlens_k`` the ``[n+1]`` cumulative starts of
    the n sequences. Returns ``(out [Tq, H, D], None)``, as the reference's
    ``(out, softmax)`` with ``return_softmax=False``."""
    if dropout and training:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is unsupported on the "
            "packed path (set dropout=0)")
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded: return_softmax=True is unsupported (the "
            "blockwise kernel never materializes the softmax)")
    dev = query.device
    cu_q = torch.as_tensor(cu_seqlens_q).to(dev, torch.int64)
    cu_k = torch.as_tensor(cu_seqlens_k).to(dev, torch.int64)
    vis = _visible(cu_q, cu_k, query.shape[0], key.shape[0], bool(causal))
    out = _fa.flash_attention(query[None], key[None], value[None],
                              causal=False, scale=float(scale),
                              mask=vis[None, None], bias_needs_grad=False)
    return out[0], None


def flash_attention_with_sparse_mask(*args, **kwargs):
    raise NotImplementedError(
        "flash_attention_with_sparse_mask: use flash_attention(mask=...) / "
        "scaled_dot_product_attention(attn_mask=...); the start-row-index "
        "compressed mask format is a flashattn-CUDA-specific encoding")
