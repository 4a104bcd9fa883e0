"""GPT family — decoder-only LM (counterpart of
``paddle_tpu/text/models/gpt.py``).

Same configuration, layer structure and parameter names as the reference
(``gpt.decoder.{i}.attn.qkv_proj.weight`` ...), at model-parallel degree 1.
The fused QKV projection is head-major: ``[b, t, H, 3, d]``, so q/k/v are
``qkv[:, :, :, 0/1/2]`` — not a ``[3, H, d]`` split. GELU is exact and the
LM head is tied to the word embeddings.

The model is built on the device it is given, with weights drawn from an
explicit ``torch.Generator``. Training calls ``model(ids, labels=...)``,
which returns ``GPTPretrainingCriterion``'s loss; serving plugs into
``inference.engine.DecodeEngine`` through :meth:`GPTForCausalLM.decode_adapter`.

Each op the reference casts under ``auto_cast`` is called through the
port's op of the same name (``tensor.add``, ``F.linear``, ...), so AMP O1
and O2 cast where the reference casts: at O1 the residual stream stays
f32 and the logits and the loss are bf16. ``use_recompute`` recomputes
each decoder layer in the backward (``distributed/fleet/utils``).
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
from ...nn import functional as F
from ...nn.functional.attention import _sdpa_dense
from ...nn.functional.loss import _masked_mean, _parallel_softmax_ce
from ...nn.layers.common import Dropout, Embedding, Linear, linear_direct
from ...nn.layers.norm import LayerNorm, layer_norm_direct

#: reference flags whose routes the port does not have yet, and the
#: ROADMAP.md item that ports each
_UNPORTED_FLAGS = {
    "sequence_parallel": "§A.7 (distributed)",
    "fold_layers": "§A.3 (one program over layer-stacked parameters)",
}


class GPTConfig:
    """Static model hyperparameters (the reference's ``GPTConfig``).

    ``use_flash_attention`` (default) takes the flash kernels on a CUDA
    tensor; False takes the dense attention (``_sdpa_reference``) on every
    device. ``sequence_parallel`` and ``fold_layers`` raise
    ``NotImplementedError`` when set: the port has no such route yet."""

    def __init__(
        self,
        vocab_size: int = 50304,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: Optional[int] = None,
        hidden_act: str = "gelu",
        max_position_embeddings: int = 1024,
        hidden_dropout_prob: float = 0.1,
        attention_probs_dropout_prob: float = 0.1,
        initializer_range: float = 0.02,
        use_recompute: bool = False,
        use_flash_attention: bool = True,
        sequence_parallel: bool = False,
        tie_word_embeddings: bool = True,
        layer_norm_epsilon: float = 1e-5,
        fold_layers: bool = False,
        recompute_granularity: str = "full",
    ):
        flags = dict(sequence_parallel=sequence_parallel,
                     fold_layers=fold_layers)
        for name, on in flags.items():
            if on:
                raise NotImplementedError(
                    f"GPTConfig({name}=True): not ported yet, see "
                    f"ROADMAP.md {_UNPORTED_FLAGS[name]}")
        if hidden_act != "gelu":
            raise ValueError(f"hidden_act {hidden_act!r} not supported; "
                             "the port implements exact 'gelu'")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute
        # "full" keeps each layer's input only; "full_attn" / "core_attn"
        # keep the matmul outputs too (the reference's dots_saveable)
        self.recompute_granularity = recompute_granularity
        self.use_flash_attention = use_flash_attention
        self.sequence_parallel = sequence_parallel
        self.tie_word_embeddings = tie_word_embeddings
        self.layer_norm_epsilon = layer_norm_epsilon
        self.fold_layers = fold_layers

    # canonical sizes (PaddleNLP gpt configs / GPT-3 table)
    @staticmethod
    def gpt2_small(**kw):
        return GPTConfig(hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, **kw)

    @staticmethod
    def gpt3_1p3b(**kw):
        kw.setdefault("num_hidden_layers", 24)
        kw.setdefault("max_position_embeddings", 2048)
        return GPTConfig(hidden_size=2048, num_attention_heads=16, **kw)

    @staticmethod
    def gpt3_6p7b(**kw):
        kw.setdefault("num_hidden_layers", 32)
        return GPTConfig(hidden_size=4096, num_attention_heads=32,
                         max_position_embeddings=2048, **kw)


def _init_kw(config, device, generator, dtype):
    return dict(device=device, dtype=dtype, generator=generator,
                init_std=config.initializer_range)


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        emb = T.add(self.word_embeddings(input_ids),
                    self.position_embeddings(position_ids))
        return self.dropout(emb)


class GPTAttention(nn.Module):
    """Causal self-attention over a fused head-major QKV projection."""

    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout_p = config.attention_probs_dropout_prob
        self.use_flash = config.use_flash_attention

    def qkv(self, x):
        """Projection + head-major split, each ``[b, t, H, d]``."""
        b, t, _ = x.shape
        qkv = T.reshape(self.qkv_proj(x),
                        (b, t, self.num_heads, 3, self.head_dim))
        return tuple(T.getitem(qkv, (Ellipsis, i, slice(None)))
                     for i in range(3))

    def forward(self, x):
        b, t, h = x.shape
        q, k, v = self.qkv(x)
        if self.use_flash:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.dropout_p, is_causal=True,
                training=self.training)
        else:
            p = self.dropout_p if self.training else 0.0
            out = _sdpa_dense(q, k, v, None, p, True, None, self.training)
        return self.out_proj(T.reshape(out, (b, t, h)))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.fc_in = Linear(config.hidden_size, config.intermediate_size,
                            **kw)
        self.fc_out = Linear(config.intermediate_size, config.hidden_size,
                             **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x)))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block."""

    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        eps = config.layer_norm_epsilon
        dev, dt = kw["device"], kw["dtype"]
        self.ln_1 = LayerNorm(config.hidden_size, eps, device=dev, dtype=dt)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, device=dev, dtype=dt)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self._use_recompute = config.use_recompute
        self._recompute_granularity = config.recompute_granularity

    def _block(self, x):
        x = T.add(x, self.dropout(self.attn(self.ln_1(x))))
        return T.add(x, self.dropout(self.mlp(self.ln_2(x))))

    def forward(self, x):
        if self._use_recompute:
            return recompute(self._block, x,
                             granularity=self._recompute_granularity)
        return self._block(x)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, **kw)
        self.decoder = nn.ModuleList(
            GPTDecoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers))
        self.final_layernorm = LayerNorm(
            config.hidden_size, config.layer_norm_epsilon,
            device=kw["device"], dtype=kw["dtype"])

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        for blk in self.decoder:
            x = blk(x)
        return self.final_layernorm(x)


class GPTPretrainingCriterion(nn.Module):
    """Masked LM loss (reference ``GPTPretrainingCriterion``). Without
    ``loss_mask`` the mean over ALL tokens, ignored labels counting as 0;
    with it ``sum(loss * mask) / max(sum(mask), 1)``."""

    ignore_index = -100

    def __init__(self, config: Optional[GPTConfig] = None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None):
        loss = _parallel_softmax_ce(logits, labels, self.ignore_index)
        if loss_mask is not None:
            return _masked_mean(loss, loss_mask)
        return T.mean(loss)


class GPTForCausalLM(nn.Module):
    """GPT with a (tied) LM head.

    ``device`` defaults to the CUDA card (``"cpu"`` only when asked);
    ``generator`` draws the random init (default: a generator on that
    device seeded with ``seed``)."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        kw = _init_kw(config, dev, generator, dtype)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias=False, **kw)
        self.criterion = GPTPretrainingCriterion(config)

    def _logits(self, hidden):
        if self.config.tie_word_embeddings:
            w = self.gpt.embeddings.word_embeddings.weight
            return F.linear(hidden, T.t(w))
        return self.lm_head(hidden)

    def forward(self, input_ids, position_ids=None, labels=None,
                loss_mask=None):
        """Logits ``[B, T, V]``, or the scalar loss when ``labels`` are
        given."""
        logits = self._logits(self.gpt(input_ids, position_ids))
        if labels is not None:
            return self.criterion(logits, labels, loss_mask)
        return logits

    def load_numpy_state(self, np_state: Mapping[str, np.ndarray]):
        """Load the reference's parameters, given as ``{name: ndarray}``;
        names and shapes must match this model's exactly."""
        return load_numpy_state(self, np_state)

    def decode_adapter(self):
        return _GPTDecodeAdapter(self)


GPTLMHeadModel = GPTForCausalLM
GPTForPretraining = GPTForCausalLM


class _GPTDecodeAdapter:
    """Per-layer hooks the serving engine drives (the engine owns the
    residual stream and the paged KV pool).

    The hooks call the layers' ops directly, past the module calls and
    the AMP gateway: serving runs outside ``auto_cast`` (a decorated model
    is not served yet, ROADMAP.md A.2c), and its steps are host-bound, so
    each Python frame shows in the decode step (PERF.md section 6)."""

    def __init__(self, lm: GPTForCausalLM):
        cfg = lm.config
        self.lm = lm
        self.blocks = list(lm.gpt.decoder)
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_positions = cfg.max_position_embeddings
        # positions may arrive [B, T] with a different offset per row (the
        # speculative verify step); the position table gathers per element
        self.multi_token_positions = True

    def embed(self, input_ids, positions):
        """input_ids ``[B, T]``; positions ``[T]`` or ``[B, T]``. Positions
        past the table (padding rows of a tail bucket only) are clamped."""
        return self.lm.gpt.embeddings(
            input_ids, positions.clamp(max=self.max_positions - 1))

    def pre_attn(self, layer, x):
        return layer_norm_direct(self.blocks[layer].ln_1, x)

    def qkv(self, layer, h, positions):
        attn = self.blocks[layer].attn
        b, t, _ = h.shape
        qkv = linear_direct(attn.qkv_proj, h).reshape(
            b, t, attn.num_heads, 3, attn.head_dim)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    def attn_out(self, layer, o):
        attn = self.blocks[layer].attn
        b, t = o.shape[0], o.shape[1]
        return linear_direct(
            attn.out_proj, o.reshape(b, t, attn.num_heads * attn.head_dim))

    def mlp(self, layer, x):
        blk = self.blocks[layer]
        h = linear_direct(blk.mlp.fc_in, layer_norm_direct(blk.ln_2, x))
        return linear_direct(blk.mlp.fc_out, F.gelu.raw(h))

    def final_norm(self, x):
        return layer_norm_direct(self.lm.gpt.final_layernorm, x)

    def logits(self, hidden):
        if self.lm.config.tie_word_embeddings:
            w = self.lm.gpt.embeddings.word_embeddings.weight
            return F.linear.raw(hidden, w.t())
        return linear_direct(self.lm.lm_head, hidden)
