"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .attention import (flash_attention, mask_fill_value, paged_attention,
                        scaled_dot_product_attention)

__all__ = ["flash_attention", "mask_fill_value", "paged_attention",
           "scaled_dot_product_attention"]
