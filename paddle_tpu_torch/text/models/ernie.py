"""ERNIE family — BERT-style encoder with task-type embeddings
(counterpart of ``paddle_tpu/text/models/ernie.py``).

``ErnieModel`` runs the BERT blocks of ``bert.py`` (post-LN, head-major
fused QKV, the additive padding mask on the flash kernels K1 / K2) under
embeddings that add a task-type table (ERNIE 3.0). Configuration,
parameter names and initialisation are the reference's;
``ErnieConfig.ernie3_base()`` is PaddleNLP's ``ernie-3.0-base-zh``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import tensor as T
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import ParamAttr
from ...nn.layers.common import Dropout, Embedding, Linear
from .bert import (BertEmbeddings, BertLMPredictionHead, _build_kw,
                   _Encoder, _Loadable, _mlm_loss)


class ErnieConfig:
    """Static model hyperparameters (the reference's ``ErnieConfig``);
    ``fold_layers`` makes the encoder the one-stage fold."""

    def __init__(
        self,
        vocab_size: int = 40000,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        hidden_act: str = "gelu",
        hidden_dropout_prob: float = 0.1,
        attention_probs_dropout_prob: float = 0.1,
        max_position_embeddings: int = 2048,
        type_vocab_size: int = 4,
        task_type_vocab_size: int = 3,
        use_task_id: bool = True,
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
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention
        self.fold_layers = fold_layers

    @staticmethod
    def ernie3_base(**kw):
        return ErnieConfig(hidden_size=768, num_hidden_layers=12,
                           num_attention_heads=12, **kw)


class ErnieEmbeddings(BertEmbeddings):
    """BERT's embeddings plus, with ``use_task_id``, a task-type table."""

    def __init__(self, config: ErnieConfig, **kw):
        super().__init__(config, **kw)
        self.use_task_id = config.use_task_id
        if config.use_task_id:
            init = ParamAttr(
                initializer=I.Normal(std=config.initializer_range))
            self.task_type_embeddings = Embedding(
                config.task_type_vocab_size, config.hidden_size,
                weight_attr=init, **kw)
            # the reference registers the task table after the token-type
            # table and before the LayerNorm: keep its parameter order
            for name in ("layer_norm", "dropout"):
                self._modules[name] = self._modules.pop(name)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        emb = self._sum(input_ids, token_type_ids, position_ids)
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            emb = T.add(emb, self.task_type_embeddings(task_type_ids))
        return self.dropout(self.layer_norm(emb))


class _ErnieBlockConfig:
    """The ``ErnieConfig`` fields the BERT blocks read."""

    def __init__(self, c: ErnieConfig):
        self.hidden_size = c.hidden_size
        self.num_attention_heads = c.num_attention_heads
        self.intermediate_size = c.intermediate_size
        self.hidden_act = c.hidden_act
        self.hidden_dropout_prob = c.hidden_dropout_prob
        self.attention_probs_dropout_prob = c.attention_probs_dropout_prob
        self.layer_norm_eps = c.layer_norm_eps
        self.use_flash_attention = c.use_flash_attention


class ErnieModel(_Encoder):
    """Embeddings, the BERT encoder blocks and the pooler; ``forward``
    returns ``(hidden, pooled or None)``. ``device`` defaults to the CUDA
    card; ``generator`` draws the random init (default: seeded with
    ``seed`` on that device)."""

    def __init__(self, config: ErnieConfig, add_pooling_layer: bool = True,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        kw = _build_kw(device, dtype, generator, seed)
        self.config = config
        self.embeddings = ErnieEmbeddings(config, **kw)
        self._build_stack(config, _ErnieBlockConfig(config),
                          add_pooling_layer, kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        return self._run(x, attention_mask)


def _build(config, device, dtype, generator, seed, add_pooling_layer):
    kw = _build_kw(device, dtype, generator, seed)
    return kw, ErnieModel(config, add_pooling_layer=add_pooling_layer, **kw)


class ErnieForMaskedLM(_Loadable):
    """ERNIE with BERT's tied masked-LM head."""

    def __init__(self, config: ErnieConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        kw, self.ernie = _build(config, device, dtype, generator, seed, False)
        self.config = config
        head_cfg = _ErnieBlockConfig(config)
        head_cfg.vocab_size = config.vocab_size
        self.cls = BertLMPredictionHead(
            head_cfg, self.ernie.embeddings.word_embeddings.weight, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        hidden, _ = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        logits = self.cls(hidden)
        return _mlm_loss(logits, labels) if labels is not None else logits


class _ErnieClassifier(_Loadable):
    def __init__(self, config, num_classes, dropout, pool, device, dtype,
                 generator, seed):
        super().__init__()
        kw, self.ernie = _build(config, device, dtype, generator, seed, pool)
        self.config = config
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 weight_init=I.XavierNormal(), **kw)


class ErnieForSequenceClassification(_ErnieClassifier):
    """ERNIE, dropout and a linear classifier over the pooled output: the
    fine-tune of BASELINE.json's headline workload. Logits ``[b,
    num_classes]``, or their cross entropy with ``labels``."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__(config, num_classes, dropout, True, device, dtype,
                         generator, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


class ErnieForTokenClassification(_ErnieClassifier):
    """ERNIE, dropout and a linear classifier at every position: logits
    ``[b, t, num_classes]``, or their cross entropy with ``labels``."""

    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__(config, num_classes, dropout, False, device, dtype,
                         generator, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        hidden, _ = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        logits = self.classifier(self.dropout(hidden))
        if labels is not None:
            return F.cross_entropy(T.reshape(logits, (-1, logits.shape[-1])),
                                   labels.reshape(-1))
        return logits


__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieModel"]
