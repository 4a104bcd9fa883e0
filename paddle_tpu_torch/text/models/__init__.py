"""Text models of the port."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTForPretraining,
                  GPTLMHeadModel, GPTModel, GPTPretrainingCriterion)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTForPretraining",
           "GPTLMHeadModel", "GPTModel", "GPTPretrainingCriterion"]
