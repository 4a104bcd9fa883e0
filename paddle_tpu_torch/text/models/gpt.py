"""GPT family — decoder-only LM (counterpart of
``paddle_tpu/text/models/gpt.py``).

Same configuration, layer structure and parameter names as the reference
(``gpt.decoder.{i}.attn.qkv_proj.weight`` ...), built, as the reference's,
from the fleet mp layers (``VocabParallelEmbedding``,
``ColumnParallelLinear`` / ``RowParallelLinear``, ``ParallelCrossEntropy``),
which at model-parallel degree 1 are the plain layers. The fused QKV
projection is head-major: ``[b, t, H, 3, d]``, so q/k/v are
``qkv[:, :, :, 0/1/2]`` — not a ``[3, H, d]`` split — and a contiguous mp
shard of its columns is a whole group of ``H / mp`` heads, which each rank
runs through the flash kernels. GELU is exact and the LM head is tied to
the word embeddings: at mp > 1 it gives vocab-sharded logits to the
vocab-parallel cross entropy.

Built after ``fleet.init`` with ``mp_degree > 1``, each rank holds its
shards (drawn whole from the generator and cut, so the full weights are
the same at every degree); ``load_numpy_state`` takes the full arrays.
``sequence_parallel=True`` (Megatron-SP, at mp > 1) splits the residual
stream along the sequence after the embedding, all-gathers it before each
column-parallel linear, reduce-scatters after each row-parallel one and
all-gathers it before the head; the norms and the row linears' biases are
sequence-parallel parameters (``fleet.utils.sequence_parallel_utils``).
At mp degree 1 it changes nothing, as in the reference.

Built after ``fleet.init`` with ``pp_degree > 1`` and a depth that it
divides, the decoder is a pipelined ``SpmdPipeline`` (this rank's stage of
the blocks; ``virtual_pp_degree`` / ``pp_schedule`` set on the config
override the strategy's), trained through ``fleet.DistTrainStep``; the
embeddings, the final norm and the tied head stay on every pipe rank, as
in the reference. ``fold_layers`` makes the decoder the one-stage fold,
whose ``state_dict`` holds the reference's stacked layout
(``gpt.decoder.ln_1__weight`` of shape ``[L, h]`` ...). The KV-cached
routes need the plain decoder.

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
from ...distributed.fleet.layers import mpu
from ...distributed.fleet.meta_parallel.pipeline_parallel import (
    SpmdPipeline, _pipe_degree, fold_or_list, run_stack)
from ...distributed.fleet.utils import recompute
from ...distributed.fleet.utils import sequence_parallel_utils as spu
from ...framework.io_state import load_numpy_state
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.functional import ring_attention as _ring
from ...nn.functional.attention import _sdpa_dense
from ...nn.functional.loss import _masked_mean, _parallel_softmax_ce
from ...nn.layer import Layer, LayerList
from ...nn.layers.common import Dropout, Embedding, linear_direct
from ...nn.layers.norm import LayerNorm, layer_norm_direct
from ..generation import alloc_kv_caches, run_cached_generation
from . import _mp_decode as _mpd
from .llama import _cache_write, _decode_attention


class GPTConfig:
    """Static model hyperparameters (the reference's ``GPTConfig``).

    ``use_flash_attention`` (default) takes the flash kernels on a CUDA
    tensor; False takes the dense attention (``_sdpa_reference``) on every
    device. ``fold_layers`` builds the decoder as the one-stage fold."""

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


def _linear(config, kind, n_in, n_out, kw, **extra):
    """A parallel linear (``spu.parallel_linear``) initialized as the
    port's ``Linear``: normal at ``initializer_range``."""
    return spu.parallel_linear(
        kind, n_in, n_out, config.sequence_parallel, device=kw["device"],
        dtype=kw["dtype"], generator=kw["generator"],
        weight_init=I.Normal(0.0, kw["init_std"]), **extra)


class GPTEmbeddings(Layer):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.word_embeddings = mpu.VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            t = input_ids.shape[1]
            off = _ring.sequence_offset(t)  # the rank's block when split
            position_ids = torch.arange(off, off + t,
                                        device=input_ids.device)
        emb = T.add(self.word_embeddings(input_ids),
                    self.position_embeddings(position_ids))
        return self.dropout(emb)


class GPTAttention(Layer):
    """Causal self-attention over a fused head-major QKV projection."""

    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        mp = mpu._mp_group()[1]
        if config.num_attention_heads % mp:
            raise ValueError(f"num_attention_heads "
                             f"{config.num_attention_heads} does not divide "
                             f"by the mp degree {mp}")
        self.num_heads = config.num_attention_heads // mp  # this rank's
        self.head_dim = h // config.num_attention_heads
        self.qkv_proj = _linear(config, "col", h, 3 * h, kw)
        self.out_proj = _linear(config, "row", h, h, kw)
        self.dropout_p = config.attention_probs_dropout_prob
        self.use_flash = config.use_flash_attention

    def qkv(self, x):
        """Projection + head-major split, each ``[b, t, H / mp, d]`` (``t``
        the full sequence under sequence parallelism)."""
        y = self.qkv_proj(x)
        b, t = y.shape[0], y.shape[1]
        qkv = T.reshape(y, (b, t, self.num_heads, 3, self.head_dim))
        return tuple(T.getitem(qkv, (Ellipsis, i, slice(None)))
                     for i in range(3))

    def forward(self, x):
        q, k, v = self.qkv(x)
        b, t = q.shape[0], q.shape[1]
        h = self.num_heads * self.head_dim
        if self.use_flash:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.dropout_p, is_causal=True,
                training=self.training)
        else:
            p = self.dropout_p if self.training else 0.0
            out = _sdpa_dense(q, k, v, None, p, True, None, self.training)
        return self.out_proj(T.reshape(out, (b, t, h)))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.fc_in = _linear(config, "col", config.hidden_size,
                             config.intermediate_size, kw)
        self.fc_out = _linear(config, "row", config.intermediate_size,
                              config.hidden_size, kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x)))


class GPTDecoderLayer(Layer):
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
        spu.mark_sequence_parallel_layers(config.sequence_parallel, self.ln_1,
                                          self.ln_2)
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


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, **kw)
        blocks = [GPTDecoderLayer(config, **kw)
                  for _ in range(config.num_hidden_layers)]
        pp = _pipe_degree()
        if pp > 1 and config.num_hidden_layers % pp == 0:
            self.decoder = SpmdPipeline(
                blocks, num_stages=pp, recompute_block=config.use_recompute,
                recompute_granularity=config.recompute_granularity,
                # per-model overrides; None defers to the strategy's
                # pipeline_configs / PADDLE_TPU_PP_SCHEDULE
                num_virtual_stages=getattr(config, "virtual_pp_degree", None),
                schedule=getattr(config, "pp_schedule", None))
        else:
            self.decoder = fold_or_list(
                blocks, config.fold_layers, recompute=config.use_recompute,
                recompute_granularity=config.recompute_granularity)
        self.final_layernorm = LayerNorm(
            config.hidden_size, config.layer_norm_epsilon,
            device=kw["device"], dtype=kw["dtype"])
        spu.mark_sequence_parallel_layers(config.sequence_parallel,
                                          self.final_layernorm)
        self._sequence_parallel = spu.sequence_parallel_on(
            config.sequence_parallel)

    def forward(self, input_ids, position_ids=None):
        """The final hidden states; under sequence parallelism this
        rank's part of the sequence."""
        x = self.embeddings(input_ids, position_ids)
        if self._sequence_parallel:
            x = spu.ScatterOp.apply(x)
        x = run_stack(self.decoder, x)
        return self.final_layernorm(x)


class GPTPretrainingCriterion(Layer):
    """Masked LM loss (reference ``GPTPretrainingCriterion``). Without
    ``loss_mask`` the mean over ALL tokens, ignored labels counting as 0;
    with it ``sum(loss * mask) / max(sum(mask), 1)``."""

    ignore_index = -100

    def __init__(self, config: Optional[GPTConfig] = None):
        super().__init__()
        # the logits are vocab-parallel when the model is built at mp > 1
        # (a model built whole and split later by parallelize keeps them
        # whole)
        self._vocab_parallel = mpu._mp_group()[1] > 1

    def forward(self, logits, labels, loss_mask=None):
        loss = (mpu.parallel_cross_entropy(logits, labels, self.ignore_index)
                if self._vocab_parallel else
                _parallel_softmax_ce(logits, labels, self.ignore_index))
        if loss_mask is not None:
            return _masked_mean(loss, loss_mask)
        return T.mean(loss)


class GPTForCausalLM(Layer):
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
            self.lm_head = _linear(config, "col", config.hidden_size,
                                   config.vocab_size, kw, has_bias=False)
        self.criterion = GPTPretrainingCriterion(config)

    def _logits(self, hidden):
        """Logits (vocab-sharded at mp > 1) of the final hidden states."""
        if self.config.tie_word_embeddings:
            emb = self.gpt.embeddings.word_embeddings
            hidden = spu.tied_head_input(hidden, emb,
                                         self.gpt._sequence_parallel)
            return F.linear(hidden, T.t(emb.weight))
        return self.lm_head(hidden)

    def whole_vocab(self, logits):
        """``logits`` over the whole vocabulary: at mp > 1 the ranks'
        vocab blocks all-gathered along the last dim (a collective)."""
        emb = self.gpt.embeddings.word_embeddings
        if emb.world_size == 1:
            return logits
        return mpu.full_of(logits, logits.dim() - 1, emb._group)

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
        names and (full) shapes must match this model's exactly; an mp
        shard keeps its part of the full array."""
        return load_numpy_state(self, np_state)

    def decode_adapter(self, mp_group=None):
        """The engine's hooks (``_GPTDecodeAdapter``); ``mp_group`` serves
        this rank's heads and vocab block of a whole model."""
        return _GPTDecodeAdapter(self, mp_group)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, top_k: int = 0, top_p: float = 1.0,
                 temperature: float = 1.0, eos_token_id=None,
                 pad_token_id=None, seed=None):
        """KV-cached generation (see ``LlamaForCausalLM.generate``)."""
        return run_cached_generation(
            self,
            lambda ids, caches, pos: _gpt_cached_forward(
                self.gpt, ids, caches, pos),
            lambda b, n: _gpt_init_cache(self.gpt, b, n),
            self._logits,
            input_ids, max_new_tokens=max_new_tokens, do_sample=do_sample,
            top_k=top_k, top_p=top_p, temperature=temperature,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed)


GPTLMHeadModel = GPTForCausalLM
GPTForPretraining = GPTForCausalLM


# ---------------------------------------------------------------------------
# KV-cached decoding, as in llama.py (whose cache write and cache
# attention it shares). The projection is ``GPTAttention.qkv``, the one
# the full forward runs; the prefill's causal attention is
# ``scaled_dot_product_attention`` (K1 on the card).
# ---------------------------------------------------------------------------


def _gpt_attn_cached(attn: GPTAttention, x, cache, pos: Optional[int]):
    """Prefill (``pos`` None) or one-step decode against the cache."""
    b, t, h = x.shape
    q, k, v = attn.qkv(x)
    _cache_write(cache["k"], k, 0 if pos is None else pos)
    _cache_write(cache["v"], v, 0 if pos is None else pos)
    if pos is None:
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=False)
    else:
        o = _decode_attention(q, cache["k"], cache["v"], pos)
    return attn.out_proj(T.reshape(o, (b, t, -1)))  # this rank's heads


def _gpt_cached_forward(model: GPTModel, input_ids, caches,
                        pos: Optional[int]):
    """Hidden states ``[B, t, h]``: the prefill (``pos`` None) or one
    decode step, whose position id ``[1]`` broadcasts over the batch."""
    if not isinstance(model.decoder, LayerList):
        raise NotImplementedError(
            "KV-cache decoding requires the non-pipelined decoder "
            "(pp_degree=1); pipelined serving uses generate_padded")
    if pos is None:
        x = model.embeddings(input_ids)
    else:
        x = model.embeddings(input_ids, torch.arange(
            pos, pos + 1, device=input_ids.device))
    for blk, cache in zip(model.decoder, caches):
        x = T.add(x, _gpt_attn_cached(blk.attn, blk.ln_1(x), cache, pos))
        x = T.add(x, blk.mlp(blk.ln_2(x)))
    return model.final_layernorm(x)


def _gpt_init_cache(model: GPTModel, batch_size: int, max_length: int):
    c = model.config
    heads = model.decoder[0].attn.num_heads  # this rank's at mp > 1
    return alloc_kv_caches(
        c.num_hidden_layers, batch_size, max_length, heads,
        c.hidden_size // c.num_attention_heads,
        device=model.embeddings.word_embeddings.weight.device)


class _GPTDecodeAdapter:
    """Per-layer hooks the serving engine drives (the engine owns the
    residual stream and the paged KV pool).

    At mp > 1 (``mp_group``, or a model built split) the hooks serve this
    rank's heads and vocab block (``_mp_decode.py``): :meth:`qkv` gives the
    rank's ``H / mp`` heads, :meth:`attn_out` sums the output projection
    over the group, :meth:`logits` gives the rank's vocab block.

    The hooks call the layers' ops directly, past the module calls and
    the AMP gateway: serving runs outside ``auto_cast``, as the
    reference's engine does, and its steps are host-bound, so each Python
    frame shows in the decode step (PERF.md section 6). Each hook computes
    in its input's dtype, which is the parameters': a ``decorate``d O2
    model is served in bf16 at every hook (embed, the norms, qkv, K3's
    query and output, the out projection, the MLP, the logits), the dtypes
    the reference's adapter runs such a model in (measured on its
    ``DecodeEngine``); the engine casts the logits to f32 before
    sampling."""

    def __init__(self, lm: GPTForCausalLM, mp_group=None):
        if not isinstance(lm.gpt.decoder, LayerList):
            raise NotImplementedError(
                "the decode engine requires the non-pipelined, unfolded "
                "decoder (pp_degree=1, fold_layers=False)")
        cfg = lm.config
        self.lm = lm
        self.blocks = list(lm.gpt.decoder)
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_positions = cfg.max_position_embeddings
        self.vocab_size = cfg.vocab_size
        # positions may arrive [B, T] with a different offset per row (the
        # speculative verify step); the position table gathers per element
        self.multi_token_positions = True
        emb = lm.gpt.embeddings.word_embeddings
        split = emb.world_size > 1
        self.mp_group = _mpd.resolve_group(emb._group if split else None,
                                           mp_group)
        self.mp = sh = _mpd.MpShard(self.mp_group, split)
        if self.num_heads % sh.world:
            raise ValueError(
                f"mp={sh.world} must divide num_kv_heads={self.num_kv_heads}"
                ": the KV pool shards by whole kv heads")
        self._heads = self.num_heads // sh.world
        d, h = self.head_dim, self.num_heads
        # (qkv weight, qkv bias, out weight, out bias) of the rank's heads
        self._attn = [
            (sh.cols(b.attn.qkv_proj.weight, h, 3 * d),
             sh.cols(b.attn.qkv_proj.bias, h, 3 * d),
             sh.rows(b.attn.out_proj.weight, h, d), b.attn.out_proj.bias)
            for b in self.blocks]

    def embed(self, input_ids, positions):
        """input_ids ``[B, T]``; positions ``[T]`` or ``[B, T]``. Positions
        past the table (padding rows of a tail bucket only) are clamped."""
        return self.lm.gpt.embeddings(
            input_ids, positions.clamp(max=self.max_positions - 1))

    def pre_attn(self, layer, x):
        return layer_norm_direct(self.blocks[layer].ln_1, x)

    def qkv(self, layer, h, positions):
        w, b_, _, _ = self._attn[layer]
        b, t, _ = h.shape
        qkv = F.linear.raw(h, w, b_).reshape(b, t, self._heads, 3,
                                             self.head_dim)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    def attn_out(self, layer, o):
        _, _, w, bias = self._attn[layer]
        b, t = o.shape[0], o.shape[1]
        return self.mp.row_linear(
            o.reshape(b, t, self._heads * self.head_dim), w, bias)

    def mlp(self, layer, x):
        blk = self.blocks[layer]
        h = linear_direct(blk.mlp.fc_in, layer_norm_direct(blk.ln_2, x))
        fc_out = blk.mlp.fc_out
        if not self.mp.model_split:
            return linear_direct(fc_out, F.gelu.raw(h))
        return self.mp.row_linear(F.gelu.raw(h), fc_out.weight, fc_out.bias)

    def final_norm(self, x):
        return layer_norm_direct(self.lm.gpt.final_layernorm, x)

    def logits(self, hidden):
        """The logits, at mp > 1 this rank's vocab block (``_mp_decode.
        head_logits``)."""
        if self.lm.config.tie_word_embeddings:
            return _mpd.head_logits(
                hidden, self.lm.gpt.embeddings.word_embeddings.weight, True,
                self.mp, self.vocab_size)
        return _mpd.head_logits(hidden, self.lm.lm_head.weight, False,
                                self.mp, self.vocab_size)
