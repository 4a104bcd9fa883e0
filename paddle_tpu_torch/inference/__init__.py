"""Serving engine of the port."""
from .engine import (DecodeEngine, EngineConfig, PagePool, PrefixRegistry,
                     SamplingParams, pow2_bucket)

__all__ = ["DecodeEngine", "EngineConfig", "PagePool", "PrefixRegistry",
           "SamplingParams", "pow2_bucket"]
