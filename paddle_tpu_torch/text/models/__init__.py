"""Text models of the port."""
from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel"]
