"""Text models of the port."""
from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,
                   BertModel, BertPretrainingCriterion)
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification,
                    ErnieForTokenClassification, ErnieModel)
from .gpt import (GPTConfig, GPTForCausalLM, GPTForPretraining,
                  GPTLMHeadModel, GPTModel, GPTPretrainingCriterion)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel)

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "BertPretrainingCriterion", "ErnieConfig",
           "ErnieForMaskedLM", "ErnieForSequenceClassification",
           "ErnieForTokenClassification", "ErnieModel", "GPTConfig",
           "GPTForCausalLM", "GPTForPretraining", "GPTLMHeadModel",
           "GPTModel", "GPTPretrainingCriterion",
           "LlamaConfig", "LlamaDecoderLayer", "LlamaForCausalLM",
           "LlamaModel"]
