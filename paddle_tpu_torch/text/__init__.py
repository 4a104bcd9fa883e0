"""Text models and generation helpers of the port."""
