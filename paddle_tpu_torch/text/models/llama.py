"""Llama family — RoPE + RMSNorm + SwiGLU + grouped-query attention
(counterpart of ``paddle_tpu/text/models/llama.py``).

Same configuration, layer structure and state names as the reference
(``llama.layers.{i}.self_attn.q_proj.weight`` ...), at model-parallel
degree 1 with a plain ``ModuleList`` of decoder layers. Each attention
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
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ... import tensor as T
from ...device import resolve_device
from ...distributed.fleet.utils import recompute
from ...framework.io_state import load_numpy_state
from ...framework.op import amp_op
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.functional.loss import _masked_mean, _parallel_softmax_ce
from ...nn.layers.common import Embedding, Linear, linear_direct
from ...nn.layers.norm import RMSNorm, rms_norm_direct
from ...ops.flash_attention import flash_attention

#: reference flags whose routes the port does not have yet, and the
#: ROADMAP.md item that ports each
_UNPORTED_FLAGS = {
    "fold_layers": "§A.3 (one program over layer-stacked parameters)",
    "sequence_parallel": "§A.7 (distributed)",
}


class LlamaConfig:
    """Static model hyperparameters (the reference's ``LlamaConfig``).

    ``fold_layers`` and ``sequence_parallel`` raise
    ``NotImplementedError`` when set: the port has no such route yet."""

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
        flags = dict(fold_layers=fold_layers,
                     sequence_parallel=sequence_parallel)
        for name, on in flags.items():
            if on:
                raise NotImplementedError(
                    f"LlamaConfig({name}=True): not ported yet, see "
                    f"ROADMAP.md {_UNPORTED_FLAGS[name]}")
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
    """x ``[B, T, H, D]`` rotated at positions ``0 .. T-1``; cos / sin
    ``[Tmax, D/2]``. The rotation promotes bf16 x with f32 tables to f32
    (O1) and is cast back to x's dtype."""
    t = x.shape[1]
    return _rotate(x, cos[:t][None, :, None, :], sin[:t][None, :, None, :])


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
    """Causal flash attention over k / v at their kv heads (K1 / K2)."""
    return flash_attention(q, k, v, causal=True)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        kv_h = self.num_kv_heads * self.head_dim
        lin = dict(bias=False, weight_init=I.XavierNormal(), **kw)
        self.q_proj = Linear(h, h, **lin)
        self.k_proj = Linear(h, kv_h, **lin)
        self.v_proj = Linear(h, kv_h, **lin)
        self.o_proj = Linear(h, h, **lin)
        cos, sin = _rope_cache(config.max_position_embeddings, self.head_dim,
                               config.rope_theta)
        self.register_buffer("rope_cos", torch.as_tensor(cos,
                                                         device=kw["device"]))
        self.register_buffer("rope_sin", torch.as_tensor(sin,
                                                         device=kw["device"]))
        self.use_flash = config.use_flash_attention

    def qkv(self, x):
        """Projections before RoPE: q ``[b, t, H, d]``, k / v
        ``[b, t, Hkv, d]``."""
        b, t, _ = x.shape
        q = T.reshape(self.q_proj(x), (b, t, self.num_heads, self.head_dim))
        k = T.reshape(self.k_proj(x),
                      (b, t, self.num_kv_heads, self.head_dim))
        v = T.reshape(self.v_proj(x),
                      (b, t, self.num_kv_heads, self.head_dim))
        return q, k, v

    def forward(self, x):
        b, t, h = x.shape
        q, k, v = self.qkv(x)
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


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        lin = dict(bias=False, weight_init=I.XavierNormal(), **kw)
        self.gate_proj = Linear(h, i, **lin)
        self.up_proj = Linear(h, i, **lin)
        self.down_proj = Linear(i, h, **lin)

    def forward(self, x):
        return self.down_proj(T.multiply(F.silu(self.gate_proj(x)),
                                         self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    """Pre-RMSNorm block with two residuals."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        norm = dict(epsilon=config.rms_norm_eps, device=kw["device"],
                    dtype=kw["dtype"])
        self.input_layernorm = RMSNorm(config.hidden_size, **norm)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **norm)
        self.mlp = LlamaMLP(config, **kw)
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


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      init_std=config.initializer_range,
                                      **kw)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=kw["device"], dtype=kw["dtype"])

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for blk in self.layers:
            x = blk(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
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
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias=False, weight_init=I.XavierNormal(),
                                  **kw)

    def _logits(self, hidden):
        if self.config.tie_word_embeddings:
            return F.linear(hidden, T.t(self.llama.embed_tokens.weight))
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, loss_mask=None):
        """Logits ``[B, T, V]``, or the scalar loss when ``labels`` (already
        shifted by the caller) are given: with ``loss_mask``
        ``sum(loss * mask) / max(sum(mask), 1)``, else the mean over the
        tokens whose label is not ``-100``."""
        logits = self._logits(self.llama(input_ids))
        if labels is None:
            return logits
        loss = _parallel_softmax_ce(logits, labels, self.ignore_index)
        if loss_mask is not None:
            return _masked_mean(loss, loss_mask)
        valid = (labels.reshape(loss.shape) != self.ignore_index).to(
            loss.dtype)
        return T.divide(T.sum(loss), T.clip(T.sum(valid), min=1.0))

    def load_numpy_state(self, np_state: Mapping[str, np.ndarray]):
        """Load the reference's state (parameters and RoPE tables), given
        as ``{name: ndarray}``; names and shapes must match exactly."""
        return load_numpy_state(self, np_state)

    def decode_adapter(self):
        return _LlamaDecodeAdapter(self)


class _LlamaDecodeAdapter:
    """Per-layer hooks the serving engine drives (see ``_GPTDecodeAdapter``
    for the contract, and for why the hooks call the ops directly). RoPE
    is applied inside :meth:`qkv` at the engine's explicit positions, so
    prefill buckets and per-slot decode share one code path."""

    def __init__(self, lm: LlamaForCausalLM):
        cfg = lm.config
        self.lm = lm
        self.blocks = list(lm.llama.layers)
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_positions = cfg.max_position_embeddings
        # positions may arrive [B, T] with a different offset per row (the
        # speculative verify step); RoPE gathers per element
        self.multi_token_positions = True

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
        b, t, _ = h.shape
        hq, hkv, d = attn.num_heads, attn.num_kv_heads, attn.head_dim
        q = linear_direct(attn.q_proj, h).reshape(b, t, hq, d)
        k = linear_direct(attn.k_proj, h).reshape(b, t, hkv, d)
        v = linear_direct(attn.v_proj, h).reshape(b, t, hkv, d)
        pos = positions.clamp(max=self.max_positions - 1)
        rope = _apply_rope_positions.raw
        q = rope(q, attn.rope_cos, attn.rope_sin, pos)
        k = rope(k, attn.rope_cos, attn.rope_sin, pos)
        return q, k, v

    def attn_out(self, layer, o):
        attn = self.blocks[layer].self_attn
        b, t = o.shape[0], o.shape[1]
        return linear_direct(
            attn.o_proj, o.reshape(b, t, attn.num_heads * attn.head_dim))

    def mlp(self, layer, x):
        blk = self.blocks[layer]
        mlp = blk.mlp
        h = rms_norm_direct(blk.post_attention_layernorm, x)
        return linear_direct(mlp.down_proj,
                             F.silu.raw(linear_direct(mlp.gate_proj, h))
                             * linear_direct(mlp.up_proj, h))

    def final_norm(self, x):
        return rms_norm_direct(self.lm.llama.norm, x)

    def logits(self, hidden):
        if self.lm.config.tie_word_embeddings:
            w = self.lm.llama.embed_tokens.weight
            return F.linear.raw(hidden, w.t())
        return linear_direct(self.lm.lm_head, hidden)
