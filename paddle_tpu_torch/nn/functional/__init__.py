"""Functional ops of the port (``paddle.nn.functional`` counterparts)."""
from .attention import (mask_fill_value, paged_attention,
                        scaled_dot_product_attention)

__all__ = ["mask_fill_value", "paged_attention",
           "scaled_dot_product_attention"]
