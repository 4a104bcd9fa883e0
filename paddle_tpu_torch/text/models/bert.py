"""BERT family — encoder LM (counterpart of
``paddle_tpu/text/models/bert.py``).

Same configuration, layer structure and parameter names as the reference
(``bert.encoder.{i}.attention.qkv_proj.weight`` ...), at model-parallel
degree 1. Post-LN blocks; the fused QKV projection is head-major, ``[b,
t, H, 3, d]``, so q / k / v reach the attention as strided views of it.
An ``attention_mask`` ``[b, t]`` (1 = keep) becomes the additive mask
``(1 - m) * -1e9`` of shape ``[b, 1, 1, t]``, as in the reference, and the
attention is non-causal: on CUDA tensors with no active dropout it runs
the flash kernels K1 / K2 with that mask as a bias that takes no gradient
(``nn/functional/attention.py::padded_attention``); with attention dropout
active (training at ``attention_probs_dropout_prob > 0``) it takes the
dense route, as the reference does.

Weights as the reference initialises them: embeddings normal with std
``initializer_range`` (through ``ParamAttr``), projections XavierNormal,
biases 0; drawn from an explicit ``torch.Generator`` on the device the
model is built on. The masked-LM head is tied to the word embeddings and
adds its own ``decoder_bias``. ``fold_layers`` makes the encoder the
one-stage fold (``distributed/fleet/meta_parallel/pipeline_parallel.py``),
the padding mask given to every block, the state in the reference's
stacked layout (``bert.encoder.ln_1__weight`` ``[L, h]`` ...).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ... import tensor as T
from ...device import resolve_device
from ...distributed.fleet.meta_parallel.pipeline_parallel import (
    fold_or_list, run_stack)
from ...framework.io_state import load_numpy_state
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.functional import ring_attention as _ring
from ...nn.functional.attention import padded_attention
from ...nn.layer import Layer, ParamAttr, create_parameter
from ...nn.layers.common import Dropout, Embedding, Linear
from ...nn.layers.norm import LayerNorm


class BertConfig:
    """Static model hyperparameters (the reference's ``BertConfig``; the
    defaults are BERT-base: Devlin et al. 2019). ``use_flash_attention``
    False takes the dense attention on every device; ``fold_layers``
    builds the encoder as the one-stage fold."""

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        hidden_act: str = "gelu",
        hidden_dropout_prob: float = 0.1,
        attention_probs_dropout_prob: float = 0.1,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        initializer_range: float = 0.02,
        pad_token_id: int = 0,
        layer_norm_eps: float = 1e-12,
        use_flash_attention: bool = True,
        fold_layers: bool = False,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention
        self.fold_layers = fold_layers


def _build_kw(device, dtype, generator, seed):
    """The device, dtype and generator a top-level model builds with."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return dict(device=dev, dtype=dtype, generator=generator)


def _norm_kw(kw):
    return dict(device=kw["device"], dtype=kw["dtype"])


def padding_mask(attention_mask):
    """The additive mask ``[b, 1, 1, t]`` of a keep-mask ``[b, t]``: 0 where
    kept, -1e9 where padded, in f32 (the reference's arithmetic)."""
    m = attention_mask.to(torch.float32)
    return ((1.0 - m) * -1e9)[:, None, None, :]


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        init = ParamAttr(initializer=I.Normal(std=config.initializer_range))
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h,
                                         weight_attr=init, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, h, weight_attr=init, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               weight_attr=init, **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **_norm_kw(kw))
        self.dropout = Dropout(config.hidden_dropout_prob)

    def _sum(self, input_ids, token_type_ids, position_ids):
        if position_ids is None:
            t = input_ids.shape[1]
            off = _ring.sequence_offset(t)  # the rank's block when split
            position_ids = torch.arange(off, off + t,
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        return T.add(T.add(self.word_embeddings(input_ids),
                           self.position_embeddings(position_ids)),
                     self.token_type_embeddings(token_type_ids))

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        emb = self._sum(input_ids, token_type_ids, position_ids)
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(Layer):
    """Non-causal self-attention over a fused head-major QKV projection."""

    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = Linear(h, 3 * h, weight_init=I.XavierNormal(), **kw)
        self.out_proj = Linear(h, h, weight_init=I.XavierNormal(), **kw)
        self.dropout_p = config.attention_probs_dropout_prob
        self.use_flash = config.use_flash_attention

    def forward(self, x, attn_mask=None):
        b, t, h = x.shape
        qkv = T.reshape(self.qkv_proj(x),
                        (b, t, self.num_heads, 3, self.head_dim))
        q, k, v = (T.getitem(qkv, (slice(None),) * 3 + (i,))
                   for i in range(3))
        out = padded_attention(q, k, v, attn_mask, self.dropout_p,
                               self.training, self.use_flash)
        return self.out_proj(T.reshape(out, (b, t, h)))


class BertLayer(Layer):
    """Post-LN encoder block (the BERT convention)."""

    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config, **kw)
        self.ln_1 = LayerNorm(h, eps, **_norm_kw(kw))
        self.fc_in = Linear(h, config.intermediate_size,
                            weight_init=I.XavierNormal(), **kw)
        self.fc_out = Linear(config.intermediate_size, h,
                             weight_init=I.XavierNormal(), **kw)
        self.ln_2 = LayerNorm(h, eps, **_norm_kw(kw))
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.act = getattr(F, config.hidden_act)

    def forward(self, x, attn_mask=None):
        x = self.ln_1(T.add(x, self.dropout(self.attention(x, attn_mask))))
        return self.ln_2(T.add(
            x, self.dropout(self.fc_out(self.act(self.fc_in(x))))))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            weight_init=I.XavierNormal(), **kw)

    def forward(self, hidden):
        return F.tanh(self.dense(T.getitem(hidden, (slice(None), 0))))


class _Encoder(Layer):
    """Embeddings, the stack of :class:`BertLayer` and the optional pooler:
    the body that ``BertModel`` and ``ErnieModel`` share. ``embeddings`` is
    built by the subclass."""

    def _build_stack(self, config, block_config, add_pooling_layer, kw):
        self.encoder = fold_or_list(
            [BertLayer(block_config, **kw)
             for _ in range(config.num_hidden_layers)],
            config.fold_layers)
        self.pooler = (BertPooler(block_config, **kw) if add_pooling_layer
                       else None)

    def _run(self, x, attention_mask):
        extra = () if attention_mask is None else (
            padding_mask(attention_mask),)
        x = run_stack(self.encoder, x, *extra)
        pooled = self.pooler(x) if self.pooler is not None else None
        return x, pooled


class BertModel(_Encoder):
    """Embeddings, encoder and pooler; ``forward`` returns ``(hidden
    [b, t, h], pooled [b, h] or None)``. ``device`` defaults to the CUDA
    card (``"cpu"`` only when asked); ``generator`` draws the random init
    (default: a generator on that device seeded with ``seed``)."""

    def __init__(self, config: BertConfig, add_pooling_layer: bool = True,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        kw = _build_kw(device, dtype, generator, seed)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        self._build_stack(config, config, add_pooling_layer, kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        return self._run(x, attention_mask)


class BertLMPredictionHead(Layer):
    """Transform (dense, GELU, LayerNorm), then the vocabulary projection:
    the word embeddings' transpose when ``embedding_weights`` is given
    (held by reference, not registered again, so the state names are the
    reference's), else a ``decoder`` Linear; plus ``decoder_bias``."""

    def __init__(self, config, embedding_weights=None, **kw):
        super().__init__()
        h = config.hidden_size
        self.transform = Linear(h, h, weight_init=I.XavierNormal(), **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps,
                                    **_norm_kw(kw))
        self._tied = (None if embedding_weights is None
                      else (embedding_weights,))
        if embedding_weights is None:
            self.decoder = Linear(h, config.vocab_size,
                                  weight_init=I.XavierNormal(), **kw)
        self.decoder_bias = create_parameter(
            (config.vocab_size,), is_bias=True, **kw)

    def forward(self, hidden):
        h = self.layer_norm(F.gelu(self.transform(hidden)))
        if self._tied is not None:
            logits = F.linear(h, T.t(self._tied[0]))
        else:
            logits = self.decoder(h)
        return T.add(logits, self.decoder_bias)


def _mlm_loss(logits, labels):
    return F.cross_entropy(T.reshape(logits, (-1, logits.shape[-1])),
                           labels.reshape(-1), ignore_index=-100)


class _Loadable(Layer):
    def load_numpy_state(self, np_state: Mapping[str, np.ndarray]):
        """Load the reference's parameters, given as ``{name: ndarray}``;
        names and shapes must match this model's exactly."""
        return load_numpy_state(self, np_state)


class BertForMaskedLM(_Loadable):
    """BERT with the tied masked-LM head: logits ``[b, t, vocab]``, or the
    mean cross entropy over the labels that are not -100."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        kw = _build_kw(device, dtype, generator, seed)
        self.config = config
        self.bert = BertModel(config, add_pooling_layer=False, **kw)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings.weight, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        hidden, _ = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.cls(hidden)
        return _mlm_loss(logits, labels) if labels is not None else logits


class BertForSequenceClassification(_Loadable):
    """BERT, dropout and a linear classifier over the pooled output:
    logits ``[b, num_classes]``, or their cross entropy with ``labels``."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 dropout=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        kw = _build_kw(device, dtype, generator, seed)
        self.config = config
        self.bert = BertModel(config, **kw)
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 weight_init=I.XavierNormal(), **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


class BertPretrainingCriterion(Layer):
    """Masked-LM cross entropy (labels -100 ignored), plus the next-
    sentence cross entropy where both its scores and labels are given."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None):
        mlm = F.cross_entropy(
            T.reshape(prediction_scores, (-1, self.vocab_size)),
            masked_lm_labels.reshape(-1), ignore_index=-100)
        if next_sentence_labels is not None \
                and seq_relationship_score is not None:
            nsp = F.cross_entropy(seq_relationship_score,
                                  next_sentence_labels.reshape(-1))
            return T.add(mlm, nsp)
        return mlm


__all__ = ["BertConfig", "BertEmbeddings", "BertForMaskedLM",
           "BertForSequenceClassification", "BertLMPredictionHead",
           "BertLayer", "BertModel", "BertPooler", "BertPretrainingCriterion",
           "BertSelfAttention", "padding_mask"]
