"""Text models of the port."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTForPretraining,
                  GPTLMHeadModel, GPTModel, GPTPretrainingCriterion)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTForPretraining",
           "GPTLMHeadModel", "GPTModel", "GPTPretrainingCriterion",
           "LlamaConfig", "LlamaDecoderLayer", "LlamaForCausalLM",
           "LlamaModel"]
