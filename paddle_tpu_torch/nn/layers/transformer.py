"""``MultiHeadAttention`` and the encoder / decoder stacks (counterpart of
``paddle_tpu/nn/layers/transformer.py``), layer for layer as the
reference, so its state (``self_attn.q_proj.weight``,
``linear1.bias``, ``norm1.weight``, ...) bridges onto the port unchanged.

Inputs are ``[batch, seq, embed_dim]``; the attention runs on
``[B, T, H, D]``. Its routes:

- no cache, a ``Cache`` growing by concatenation, or a ``StaticCache``
  (the cross-attention's precomputed keys): ``F.scaled_dot_product_
  attention``, on CUDA tensors the flash-attention kernels K1 / K2 (with
  the mask, bool or additive, folded into K1's bias), on CPU tensors its
  dense plain version; with dropout active in training, the dense route
  on every device;
- a ``Cache`` of ``max_length`` positions with ``cache_position``: the
  new keys are written in place at that position; one query token takes
  ``F.decode_attention`` (plain torch on every device, as the
  reference's is plain jnp), a block of ``t > 1`` the flash route under
  the bool mask of positions ``<= cache_position + i``;
- a ``PagedCache``: the keys go through the page table into a pool
  ``[N, H, page_size, D]`` and the queries take ``F.paged_attention``
  (K3 on CUDA tensors).

The cache writes are inference only and in place (the reference builds
new arrays; here the returned cache holds the same tensors). A head dim
the kernels do not take (outside {64, 128}) raises on the card."""
from __future__ import annotations

import copy
from typing import Optional

import torch

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from ..layer import Layer, LayerList
from .common import Dropout, Linear
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype):
    """The mask as the attention takes it: a bool keep-mask or an additive
    float mask, both as given."""
    return attn_mask


class MultiHeadAttention(Layer):
    """``paddle.nn.MultiHeadAttention``: q / k / v / out projections
    (``kdim`` / ``vdim`` the key and value inputs' widths), ``num_heads``
    heads of ``embed_dim // num_heads``. Returns ``out``, ``(out, cache)``
    with a cache other than a ``StaticCache``, and ``None`` for the
    weights beside them when ``need_weights`` (the reference returns no
    weights either)."""

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class PagedCache:
        """K / V in a page pool ``[N, H, page_size, D]``; row ``b``'s
        position ``j`` at page ``page_table[b, j // page_size]``, offset
        ``j % page_size``. Page 0 is the trash page."""

        def __init__(self, k, v, page_table, page_size):
            self.k, self.v = k, v
            self.page_table = page_table
            self.page_size = page_size

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  weight_init=I.XavierNormal(), device=device, dtype=dtype,
                  generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim, embed_dim, **kw)
        self.v_proj = Linear(vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None, max_length=None,
                  page_size=None):
        """A ``StaticCache`` of ``key`` / ``value``'s projections (``type``
        StaticCache, or a ``value`` given); else an empty incremental
        cache for ``key``'s batch: a ``Cache`` growing by concatenation
        (``max_length`` None), one of ``max_length`` positions written at
        ``forward(cache_position=...)``, or with ``page_size`` a
        ``PagedCache`` whose row ``b`` owns pages ``1 + b * mp`` onward
        (``mp = ceil(max_length / page_size)``), all f32 zeros."""
        if type == MultiHeadAttention.StaticCache or (
                value is not None and type is None):
            k = self._split(self.k_proj(key))
            v = self._split(self.v_proj(value if value is not None
                                        else key))
            return MultiHeadAttention.StaticCache(k, v)
        b = key.shape[0]
        dev = self.q_proj.weight.device
        if page_size is not None:
            if max_length is None:
                raise ValueError("a paged cache needs max_length")
            mp = -(-max_length // page_size)
            pool = (1 + b * mp, self.num_heads, page_size, self.head_dim)
            table = (torch.arange(b * mp, dtype=torch.int32, device=dev)
                     .reshape(b, mp) + 1)
            return MultiHeadAttention.PagedCache(
                torch.zeros(pool, device=dev), torch.zeros(pool, device=dev),
                table, page_size)
        t = max_length if max_length is not None else 0
        shape = (b, t, self.num_heads, self.head_dim)
        return MultiHeadAttention.Cache(torch.zeros(shape, device=dev),
                                        torch.zeros(shape, device=dev))

    def _forward_static_cache(self, q, k, v, cache, cache_position):
        """Write k / v ``[B, t, H, D]`` at ``cache_position`` and attend
        over positions ``<= cache_position + i``."""
        b, t = q.shape[0], q.shape[1]
        ck, cv = cache.k, cache.v
        with torch.no_grad():
            ck[:, cache_position:cache_position + t] = k.to(ck.dtype)
            cv[:, cache_position:cache_position + t] = v.to(cv.dtype)
        cache = MultiHeadAttention.Cache(ck, cv)
        if t == 1:
            positions = torch.full((b,), cache_position, dtype=torch.int32,
                                   device=q.device)
            out = F.decode_attention(q, ck.transpose(1, 2),
                                     cv.transpose(1, 2), positions)
        else:
            tmax = ck.shape[1]
            mask = (torch.arange(tmax, device=q.device)[None, :]
                    <= cache_position + torch.arange(t, device=q.device)[
                        :, None])
            out = F.scaled_dot_product_attention(
                q, ck, cv, attn_mask=mask[None, None], dropout_p=self.dropout,
                is_causal=False, training=self.training)
        return out, cache

    def _forward_paged_cache(self, q, k, v, cache, cache_position):
        """Write k / v ``[B, t, H, D]`` through the page table at positions
        ``cache_position ..`` and attend through ``F.paged_attention``."""
        b, t = q.shape[0], q.shape[1]
        p = cache.page_size
        table = cache.page_table
        pos = cache_position + torch.arange(t, device=q.device)
        pg = table.long()[:, pos // p]                             # [B, t]
        off = (pos % p)[None, :].expand(b, t)
        with torch.no_grad():
            cache.k[pg, :, off, :] = k.to(cache.k.dtype)
            cache.v[pg, :, off, :] = v.to(cache.v.dtype)
        start = torch.full((b,), cache_position, dtype=torch.int32,
                           device=q.device)
        out = F.paged_attention(q, cache.k, cache.v, table, start)
        return out, cache

    def _out(self, out, cache=None, with_cache=False):
        b, t = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, t, self.embed_dim))
        if with_cache:
            return (out, None, cache) if self.need_weights else (out, cache)
        return (out, None) if self.need_weights else out

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, cache_position=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split(self.k_proj(key))
            v = self._split(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.PagedCache):
                if cache_position is None:
                    raise ValueError(
                        "a PagedCache requires forward(cache_position=...)")
                out, cache = self._forward_paged_cache(q, k, v, cache,
                                                       cache_position)
                return self._out(out, cache, True)
            if isinstance(cache, MultiHeadAttention.Cache):
                if cache_position is not None:
                    out, cache = self._forward_static_cache(
                        q, k, v, cache, cache_position)
                    return self._out(out, cache, True)
                k = torch.cat([cache.k.to(k.dtype), k], dim=1)
                v = torch.cat([cache.v.to(v.dtype), v], dim=1)
                cache = MultiHeadAttention.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask, None),
            dropout_p=self.dropout, is_causal=False, training=self.training)
        return self._out(out, cache, cache is not None and not isinstance(
            cache, MultiHeadAttention.StaticCache))


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and a
    LayerNorm after it (before it with ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        lin = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                   weight_init=I.XavierNormal(), **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **lin)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **lin)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (deep copies: they start
    from the same weights, as the reference's), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual and a LayerNorm."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        lin = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                   weight_init=I.XavierNormal(), **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **lin)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **lin)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, cache_position=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(
                tgt, tgt, tgt, tgt_mask, cache[0],
                cache_position=cache_position)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  cache[1])
        if isinstance(tgt, tuple):
            tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, cache[1]))

    def gen_cache(self, memory, max_length=None, page_size=None):
        incr = self.self_attn.gen_cache(memory, type=MultiHeadAttention.Cache,
                                        max_length=max_length,
                                        page_size=page_size)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer``, then ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, cache_position=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i],
                                        cache_position=cache_position)
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False, max_length=None,
                  page_size=None):
        cache = [layer.gen_cache(memory, max_length=max_length,
                                 page_size=page_size)
                 for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """Vaswani et al.'s encoder-decoder: ``num_encoder_layers`` encoder
    layers and ``num_decoder_layers`` decoder layers (a final LayerNorm
    on each with ``normalize_before``), or the ``custom_encoder`` /
    ``custom_decoder`` given. ``device`` / ``dtype`` / ``generator`` go to
    every layer made."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The additive causal mask ``[length, length]``: 0 on and below
        the diagonal, ``-inf`` above, on ``device`` (default: the default
        device)."""
        m = torch.full((length, length), float("-inf"),
                       device=resolve_device(device))
        return torch.triu(m, diagonal=1)


__all__ = ["MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
