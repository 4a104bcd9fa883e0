"""Llama family — RoPE + RMSNorm + SwiGLU + grouped-query attention
(counterpart of ``paddle_tpu/text/models/llama.py``).

Same configuration, layer structure and state names as the reference
(``llama.layers.{i}.self_attn.q_proj.weight`` ...), built from the fleet
mp layers as the reference's is (plain layers at model-parallel degree
1). Built after ``fleet.init`` with ``mp_degree > 1``, each rank holds
its shards and runs ``H / mp`` query heads over ``Hkv / mp`` kv heads (the
kv heads must divide by mp: a GQA group stays whole on one rank); the
untied head gives vocab-sharded logits to the vocab-parallel cross
entropy; ``sequence_parallel=True`` splits the residual stream along the
sequence as ``gpt.py`` does. Each attention
layer carries its RoPE tables as persistent buffers ``rope_cos`` /
``rope_sin`` ``[max_position_embeddings, head_dim / 2]``, built in numpy
float64 and cast to f32 as the reference builds them, so a bridged state
loads name for name. RoPE rotates the two halves of a head (the neox
pairing), not interleaved pairs.

Attention routes as in the reference: ``use_flash_attention`` (default)
calls ``ops/flash_attention.py::flash_attention`` with k / v at their
``num_key_value_heads`` (GQA-native: the kernels K1 / K2 on CUDA tensors,
their plain versions on CPU tensors); otherwise
``scaled_dot_product_attention`` over k / v repeated to every query head.
Serving plugs into ``inference.engine.DecodeEngine`` through
:meth:`LlamaForCausalLM.decode_adapter`, whose pool holds the kv heads
only (the paged kernel K3 folds each group of query heads into its rows).

As in ``gpt.py``, the ops the reference casts under ``auto_cast`` go
through the port's ops of the same names: at O1 RMSNorm runs in f32, RoPE
rotates bf16 q / k by the f32 tables, and the flash kernels take bf16; at
O2 the tables are cast to bf16 too. ``use_recompute`` recomputes each
decoder layer in the backward.

``pp_degree > 1`` and ``fold_layers`` build ``layers`` as ``gpt.py``
builds its decoder (a depth the pipe degree does not divide warns and
runs unpipelined, as the reference does); the stacked state carries the
RoPE tables as ``llama.layers.self_attn__rope_cos_stacked`` ``[L, T,
d / 2]``.
"""
from __future__ import annotations

import warnings
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ... import tensor as T
from ...device import resolve_device
from ...distributed.fleet.layers import mpu
from ...distributed.fleet.meta_parallel.pipeline_parallel import (
    SpmdPipeline, _pipe_degree, fold_or_list, run_stack)
from ...distributed.fleet.utils import recompute
from ...distributed.fleet.utils import sequence_parallel_utils as spu
from ...framework.io_state import load_numpy_state
from ...framework.op import amp_op
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.functional import ring_attention as _ring
from ...nn.functional.loss import (_denominator, _masked_mean,
                                  _parallel_softmax_ce)
from ...nn.layer import Layer, LayerList
from ...nn.layers.common import linear_direct
from ...nn.layers.norm import RMSNorm, rms_norm_direct
from ...ops.flash_attention import flash_attention
from ..generation import alloc_kv_caches, run_cached_generation
from . import _mp_decode as _mpd


class LlamaConfig:
    """Static model hyperparameters (the reference's ``LlamaConfig``);
    ``fold_layers`` builds ``layers`` as the one-stage fold."""

    def __init__(
        self,
        vocab_size: int = 32000,
        hidden_size: int = 768,
        intermediate_size: Optional[int] = None,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        num_key_value_heads: Optional[int] = None,
        max_position_embeddings: int = 2048,
        rms_norm_eps: float = 1e-6,
        rope_theta: float = 10000.0,
        initializer_range: float = 0.02,
        tie_word_embeddings: bool = False,
        use_flash_attention: bool = True,
        use_recompute: bool = False,
        sequence_parallel: bool = False,
        fold_layers: bool = False,
        recompute_granularity: str = "full",
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        # Llama SwiGLU sizing: 8/3 * h rounded up to a multiple of 256
        self.intermediate_size = intermediate_size or (
            (int(8 * hidden_size / 3) + 255) // 256 * 256)
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        if num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads {num_attention_heads} is not a "
                f"multiple of num_key_value_heads "
                f"{self.num_key_value_heads}")
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        self.tie_word_embeddings = tie_word_embeddings
        self.use_flash_attention = use_flash_attention
        self.use_recompute = use_recompute
        self.recompute_granularity = recompute_granularity
        self.sequence_parallel = sequence_parallel
        self.fold_layers = fold_layers


def _rope_cache(max_t: int, dim: int, theta: float):
    """cos / sin ``[max_t, dim / 2]`` f32, computed in float64."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(max_t, dtype=np.float64)
    freqs = np.outer(t, inv)  # [T, dim/2]
    return (np.cos(freqs).astype(np.float32),
            np.sin(freqs).astype(np.float32))


def _rotate(x, c, s):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


@amp_op("apply_rope")
def _apply_rope(x, cos, sin):
    """x ``[B, T, H, D]`` rotated at positions ``0 .. T-1`` (under a
    sequence split, the rank's block's global positions); cos / sin
    ``[Tmax, D/2]``. The rotation promotes bf16 x with f32 tables to f32
    (O1) and is cast back to x's dtype."""
    t = x.shape[1]
    off = _ring.sequence_offset(t)
    if off + t > cos.shape[0]:
        raise ValueError(f"RoPE tables of {cos.shape[0]} positions do not "
                         f"reach position {off + t - 1}")
    pos = slice(off, off + t)
    return _rotate(x, cos[pos][None, :, None, :], sin[pos][None, :, None, :])


@amp_op("rope_positions")
def _apply_rope_positions(x, cos, sin, positions):
    """x ``[B, T, H, D]`` rotated at explicit absolute ``positions``:
    ``[T]`` (shared by the batch) or ``[B, T]`` (per row), gathered from
    the cos / sin tables."""
    pos = positions.long()
    c = cos[pos][..., None, :]  # [(B,) T, 1, D/2]
    s = sin[pos][..., None, :]
    if pos.dim() == 1:
        c, s = c[None], s[None]
    return _rotate(x, c, s)


@amp_op("gqa_flash_attention")
def _gqa_attention(q, k, v):
    """Causal flash attention over k / v at their kv heads (K1 / K2; the
    ring over the sep group under a sequence split)."""
    if _ring.split_group() is not None:
        return _ring.ring_attention(q, k, v, True, None, flash=True)
    return flash_attention(q, k, v, causal=True)


def _linear(config, kind, n_in, n_out, kw):
    """A bias-free parallel linear (``spu.parallel_linear``), XavierNormal
    as in the reference."""
    return spu.parallel_linear(kind, n_in, n_out, config.sequence_parallel,
                               has_bias=False, weight_init=I.XavierNormal(),
                               **kw)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h = config.hidden_size
        mp = mpu._mp_group()[1]
        if config.num_key_value_heads % mp:
            raise ValueError(
                f"mp={mp} must divide num_key_value_heads="
                f"{config.num_key_value_heads}: each rank holds whole kv "
                "heads (a GQA group stays on one rank)")
        self.num_heads = config.num_attention_heads // mp  # this rank's
        self.num_kv_heads = config.num_key_value_heads // mp
        self.head_dim = h // config.num_attention_heads
        kv_h = config.num_key_value_heads * self.head_dim
        self.q_proj = _linear(config, "col", h, h, kw)
        self.k_proj = _linear(config, "col", h, kv_h, kw)
        self.v_proj = _linear(config, "col", h, kv_h, kw)
        self.o_proj = _linear(config, "row", h, h, kw)
        cos, sin = _rope_cache(config.max_position_embeddings, self.head_dim,
                               config.rope_theta)
        self.register_buffer("rope_cos", torch.as_tensor(cos,
                                                         device=kw["device"]))
        self.register_buffer("rope_sin", torch.as_tensor(sin,
                                                         device=kw["device"]))
        self.use_flash = config.use_flash_attention

    def qkv(self, x):
        """Projections before RoPE: q ``[b, t, H, d]``, k / v
        ``[b, t, Hkv, d]`` (this rank's heads; ``t`` the full sequence
        under sequence parallelism)."""
        q = self.q_proj(x)
        b, t = q.shape[0], q.shape[1]
        q = T.reshape(q, (b, t, self.num_heads, self.head_dim))
        k = T.reshape(self.k_proj(x),
                      (b, t, self.num_kv_heads, self.head_dim))
        v = T.reshape(self.v_proj(x),
                      (b, t, self.num_kv_heads, self.head_dim))
        return q, k, v

    def forward(self, x):
        q, k, v = self.qkv(x)
        b, t = q.shape[0], q.shape[1]
        h = self.num_heads * self.head_dim
        q = _apply_rope(q, self.rope_cos, self.rope_sin)
        k = _apply_rope(k, self.rope_cos, self.rope_sin)
        if self.use_flash:
            o = _gqa_attention(q, k, v)
        else:
            group = self.num_heads // self.num_kv_heads
            o = F.scaled_dot_product_attention(
                q, T.repeat_interleave(k, group, axis=2),
                T.repeat_interleave(v, group, axis=2), is_causal=True,
                training=self.training)
        return self.o_proj(T.reshape(o, (b, t, h)))


class LlamaMLP(Layer):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(config, "col", h, i, kw)
        self.up_proj = _linear(config, "col", h, i, kw)
        self.down_proj = _linear(config, "row", i, h, kw)

    def forward(self, x):
        return self.down_proj(T.multiply(F.silu(self.gate_proj(x)),
                                         self.up_proj(x)))


class LlamaDecoderLayer(Layer):
    """Pre-RMSNorm block with two residuals."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        norm = dict(epsilon=config.rms_norm_eps, device=kw["device"],
                    dtype=kw["dtype"])
        self.input_layernorm = RMSNorm(config.hidden_size, **norm)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **norm)
        self.mlp = LlamaMLP(config, **kw)
        spu.mark_sequence_parallel_layers(config.sequence_parallel,
                                          self.input_layernorm,
                                          self.post_attention_layernorm)
        self._use_recompute = config.use_recompute
        self._recompute_granularity = config.recompute_granularity

    def _block(self, x):
        x = T.add(x, self.self_attn(self.input_layernorm(x)))
        return T.add(x, self.mlp(self.post_attention_layernorm(x)))

    def forward(self, x):
        if self._use_recompute:
            return recompute(self._block, x,
                             granularity=self._recompute_granularity)
        return self._block(x)


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = mpu.VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            init_std=config.initializer_range, **kw)
        blocks = [LlamaDecoderLayer(config, **kw)
                  for _ in range(config.num_hidden_layers)]
        pp = _pipe_degree()
        if pp > 1 and config.num_hidden_layers % pp == 0:
            self.layers = SpmdPipeline(
                blocks, num_stages=pp, recompute_block=config.use_recompute,
                recompute_granularity=config.recompute_granularity,
                num_virtual_stages=getattr(config, "virtual_pp_degree", None),
                schedule=getattr(config, "pp_schedule", None))
        else:
            if pp > 1:
                warnings.warn(
                    f"num_hidden_layers={config.num_hidden_layers} not "
                    f"divisible by pp_degree={pp}: Llama decoder runs "
                    "WITHOUT pipeline partitioning")
            self.layers = fold_or_list(
                blocks, config.fold_layers, recompute=config.use_recompute,
                recompute_granularity=config.recompute_granularity)
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=kw["device"], dtype=kw["dtype"])
        spu.mark_sequence_parallel_layers(config.sequence_parallel,
                                          self.norm)
        self._sequence_parallel = spu.sequence_parallel_on(
            config.sequence_parallel)

    def forward(self, input_ids):
        """The final hidden states; under sequence parallelism this
        rank's part of the sequence."""
        x = self.embed_tokens(input_ids)
        if self._sequence_parallel:
            x = spu.ScatterOp.apply(x)
        x = run_stack(self.layers, x)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """Llama with an untied LM head (tied to the embeddings under
    ``tie_word_embeddings``).

    ``device`` defaults to the CUDA card (``"cpu"`` only when asked);
    ``generator`` draws the random init (default: a generator on that
    device seeded with ``seed``): embeddings normal at
    ``initializer_range``, projections XavierNormal, norms 1, as in the
    reference."""

    ignore_index = -100

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.llama = LlamaModel(config, **kw)
        if not config.tie_word_embeddings:
            self.lm_head = _linear(config, "col", config.hidden_size,
                                   config.vocab_size, kw)

    def _logits(self, hidden):
        """Logits (vocab-sharded at mp > 1) of the final hidden states."""
        if self.config.tie_word_embeddings:
            emb = self.llama.embed_tokens
            hidden = spu.tied_head_input(hidden, emb,
                                         self.llama._sequence_parallel)
            return F.linear(hidden, T.t(emb.weight))
        return self.lm_head(hidden)

    def whole_vocab(self, logits):
        """``logits`` over the whole vocabulary: at mp > 1 the ranks'
        vocab blocks all-gathered along the last dim (a collective)."""
        emb = self.llama.embed_tokens
        if emb.world_size == 1:
            return logits
        return mpu.full_of(logits, logits.dim() - 1, emb._group)

    def forward(self, input_ids, labels=None, loss_mask=None):
        """Logits ``[B, T, V]``, or the scalar loss when ``labels`` (already
        shifted by the caller) are given: with ``loss_mask``
        ``sum(loss * mask) / max(sum(mask), 1)``, else the mean over the
        tokens whose label is not ``-100``."""
        logits = self._logits(self.llama(input_ids))
        if labels is None:
            return logits
        if self.llama.embed_tokens.world_size > 1:  # vocab-parallel logits
            loss = mpu.parallel_cross_entropy(logits, labels,
                                              self.ignore_index)
        else:
            loss = _parallel_softmax_ce(logits, labels, self.ignore_index)
        if loss_mask is not None:
            return _masked_mean(loss, loss_mask)
        valid = (labels.reshape(loss.shape) != self.ignore_index).to(
            loss.dtype)
        return T.divide(T.sum(loss), _denominator(T.sum(valid)))

    def load_numpy_state(self, np_state: Mapping[str, np.ndarray]):
        """Load the reference's state (parameters and RoPE tables), given
        as ``{name: ndarray}``; names and shapes must match exactly."""
        return load_numpy_state(self, np_state)

    def decode_adapter(self, mp_group=None):
        """The engine's hooks (``_LlamaDecodeAdapter``); ``mp_group`` serves
        this rank's heads and vocab block of a whole model."""
        return _LlamaDecodeAdapter(self, mp_group)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, top_k: int = 0, top_p: float = 1.0,
                 temperature: float = 1.0, eos_token_id=None,
                 pad_token_id=None, seed=None):
        """KV-cached generation: one prefill over the prompt, then
        one-token decode steps against preallocated caches (the shared
        loop ``text.generation.run_cached_generation``). Returns numpy
        ids ``[B, T0 + n]``."""
        return run_cached_generation(
            self,
            lambda ids, caches, pos: _llama_cached_forward(
                self.llama, ids, caches, pos),
            lambda b, n: _llama_init_cache(self.llama, b, n),
            self._logits,
            input_ids, max_new_tokens=max_new_tokens, do_sample=do_sample,
            top_k=top_k, top_p=top_p, temperature=temperature,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed)


# ---------------------------------------------------------------------------
# KV-cached decoding (the reference's ``use_cache`` path): caches are
# preallocated ``[B, Tmax, Hkv, D]`` f32 buffers written in place by
# position. The prefill attends causally over the prompt (K1 on the card
# through ``_gqa_attention``); each decode step attends one query row to
# the cache through ``F.decode_attention`` (plain torch, an einsum in the
# reference too).
# ---------------------------------------------------------------------------


@amp_op("rope_at")
def _apply_rope_at(x, cos, sin, pos):
    """Rotate a single-step ``[B, 1, H, D]`` tensor at absolute position
    ``pos``."""
    return _rotate(x, cos[pos:pos + 1][None, :, None, :],
                   sin[pos:pos + 1][None, :, None, :])


def _cache_write(cache, kv, pos: int):
    """cache ``[B, Tmax, Hkv, D]`` <- kv ``[B, T, Hkv, D]`` at
    ``[pos : pos + T]``, in place; returns the cache."""
    cache[:, pos:pos + kv.shape[1]] = kv.to(cache.dtype)
    return cache


def _decode_attention(q, ck, cv, pos: int):
    """One-step attention against the cache: q ``[B, 1, H, D]`` over ck /
    cv ``[B, Tmax, Hkv, D]``, positions > ``pos`` masked. The cache is
    swapped to ``F.decode_attention``'s ``[B, Hkv, Tmax, D]`` layout and
    the position broadcast per slot."""
    b = q.shape[0]
    pos_s = torch.full((b,), pos, dtype=torch.int32, device=q.device)
    return F.decode_attention(q, ck.transpose(1, 2), cv.transpose(1, 2),
                              pos_s)


def _attn_prefill(attn: LlamaAttention, x, cache):
    b, t, h = x.shape
    q, k, v = attn.qkv(x)
    q = _apply_rope(q, attn.rope_cos, attn.rope_sin)
    k = _apply_rope(k, attn.rope_cos, attn.rope_sin)
    _cache_write(cache["k"], k, 0)
    _cache_write(cache["v"], v, 0)
    if attn.use_flash:
        o = _gqa_attention(q, k, v)
    else:
        group = attn.num_heads // attn.num_kv_heads
        o = F.scaled_dot_product_attention(
            q, T.repeat_interleave(k, group, axis=2),
            T.repeat_interleave(v, group, axis=2), is_causal=True,
            training=False)
    return attn.o_proj(T.reshape(o, (b, t, -1)))  # this rank's heads


def _attn_decode(attn: LlamaAttention, x, cache, pos: int):
    b, t, h = x.shape  # t == 1
    q, k, v = attn.qkv(x)
    q = _apply_rope_at(q, attn.rope_cos, attn.rope_sin, pos)
    k = _apply_rope_at(k, attn.rope_cos, attn.rope_sin, pos)
    _cache_write(cache["k"], k, pos)
    _cache_write(cache["v"], v, pos)
    o = _decode_attention(q, cache["k"], cache["v"], pos)
    return attn.o_proj(T.reshape(o, (b, t, -1)))  # this rank's heads


def _layer_step(layer: LlamaDecoderLayer, x, cache, pos: Optional[int]):
    h = layer.input_layernorm(x)
    if pos is None:
        a = _attn_prefill(layer.self_attn, h, cache)
    else:
        a = _attn_decode(layer.self_attn, h, cache, pos)
    x = T.add(x, a)
    return T.add(x, layer.mlp(layer.post_attention_layernorm(x)))


def _llama_cached_forward(model: LlamaModel, input_ids, caches,
                          pos: Optional[int]):
    """Hidden states ``[B, t, h]``: the prefill over the prompt (``pos``
    None) or one decode step at position ``pos``."""
    if not isinstance(model.layers, LayerList):
        raise NotImplementedError(
            "KV-cache decoding requires the non-pipelined decoder "
            "(pp_degree=1); pipelined serving uses generate_padded")
    x = model.embed_tokens(input_ids)
    for blk, cache in zip(model.layers, caches):
        x = _layer_step(blk, x, cache, pos)
    return model.norm(x)


def _llama_init_cache(model: LlamaModel, batch_size: int, max_length: int):
    c = model.config
    kv_heads = model.layers[0].self_attn.num_kv_heads  # this rank's
    return alloc_kv_caches(
        c.num_hidden_layers, batch_size, max_length, kv_heads,
        c.hidden_size // c.num_attention_heads,
        device=model.embed_tokens.weight.device)


class _LlamaDecodeAdapter:
    """Per-layer hooks the serving engine drives (see ``_GPTDecodeAdapter``
    for the contract, the mp layout, and why the hooks call the ops
    directly). RoPE is applied inside :meth:`qkv` at the engine's explicit
    positions, so prefill buckets and per-slot decode share one code path.
    At mp > 1 the rank's ``H / mp`` query heads read its ``Hkv / mp`` kv
    heads: contiguous blocks of both, so every GQA group stays whole. A
    ``decorate``d model is served in bf16 at every hook, as GPT's (RMSNorm
    normalises in f32 and returns its input's dtype; K3's verify at G = 4
    runs the tile regime on the bf16 query)."""

    def __init__(self, lm: LlamaForCausalLM, mp_group=None):
        if not isinstance(lm.llama.layers, LayerList):
            raise NotImplementedError(
                "the decode engine requires the non-pipelined, unfolded "
                "decoder (pp_degree=1, fold_layers=False)")
        cfg = lm.config
        self.lm = lm
        self.blocks = list(lm.llama.layers)
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_positions = cfg.max_position_embeddings
        self.vocab_size = cfg.vocab_size
        # positions may arrive [B, T] with a different offset per row (the
        # speculative verify step); RoPE gathers per element
        self.multi_token_positions = True
        emb = lm.llama.embed_tokens
        split = emb.world_size > 1
        self.mp_group = _mpd.resolve_group(emb._group if split else None,
                                           mp_group)
        self.mp = sh = _mpd.MpShard(self.mp_group, split)
        if self.num_kv_heads % sh.world:
            raise ValueError(
                f"mp={sh.world} must divide num_kv_heads={self.num_kv_heads}"
                ": the KV pool shards by whole kv heads (a GQA group stays "
                "on one rank)")
        self._hq = self.num_heads // sh.world
        self._hkv = self.num_kv_heads // sh.world
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads

        def proj(lin, n):
            return sh.cols(lin.weight, n, d), sh.cols(lin.bias, n, d)

        # (q, k, v projections as (weight, bias), out weight, out bias)
        self._attn = [
            (proj(a.q_proj, hq), proj(a.k_proj, hkv), proj(a.v_proj, hkv),
             sh.rows(a.o_proj.weight, hq, d), a.o_proj.bias)
            for a in (b.self_attn for b in self.blocks)]

    def embed(self, input_ids, positions):
        return self.lm.llama.embed_tokens(input_ids)

    def pre_attn(self, layer, x):
        return rms_norm_direct(self.blocks[layer].input_layernorm, x)

    def qkv(self, layer, h, positions):
        """q / k rotated at ``positions`` (``[T]`` or ``[B, T]``).
        Positions past the tables (padding rows of a tail bucket only) are
        clamped: the reference fills them with NaN, and an out-of-range
        gather on a CUDA tensor is a device-side assert."""
        attn = self.blocks[layer].self_attn
        (wq, bq), (wk, bk), (wv, bv), _, _ = self._attn[layer]
        b, t, _ = h.shape
        d = self.head_dim
        q = F.linear.raw(h, wq, bq).reshape(b, t, self._hq, d)
        k = F.linear.raw(h, wk, bk).reshape(b, t, self._hkv, d)
        v = F.linear.raw(h, wv, bv).reshape(b, t, self._hkv, d)
        pos = positions.clamp(max=self.max_positions - 1)
        rope = _apply_rope_positions.raw
        q = rope(q, attn.rope_cos, attn.rope_sin, pos)
        k = rope(k, attn.rope_cos, attn.rope_sin, pos)
        return q, k, v

    def attn_out(self, layer, o):
        *_, w, bias = self._attn[layer]
        b, t = o.shape[0], o.shape[1]
        return self.mp.row_linear(o.reshape(b, t, self._hq * self.head_dim),
                                  w, bias)

    def mlp(self, layer, x):
        blk = self.blocks[layer]
        mlp = blk.mlp
        h = rms_norm_direct(blk.post_attention_layernorm, x)
        g = F.silu.raw(linear_direct(mlp.gate_proj, h)) \
            * linear_direct(mlp.up_proj, h)
        if not self.mp.model_split:
            return linear_direct(mlp.down_proj, g)
        return self.mp.row_linear(g, mlp.down_proj.weight, mlp.down_proj.bias)

    def final_norm(self, x):
        return rms_norm_direct(self.lm.llama.norm, x)

    def logits(self, hidden):
        """The logits, at mp > 1 this rank's vocab block (``_mp_decode.
        head_logits``)."""
        if self.lm.config.tie_word_embeddings:
            return _mpd.head_logits(hidden, self.lm.llama.embed_tokens.weight,
                                    True, self.mp, self.vocab_size)
        return _mpd.head_logits(hidden, self.lm.lm_head.weight, False,
                                self.mp, self.vocab_size)
