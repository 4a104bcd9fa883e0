"""Serving engine of the port, and the switch that routes
``text.generation``'s loops through it."""
from .engine import (DecodeEngine, EngineConfig, PagePool, PrefixRegistry,
                     SamplingParams, pow2_bucket)


def enable_decode_engine(model, config=None, **kw):
    """Attach a KV-cached continuous-batching ``DecodeEngine(model, **kw)``
    (``EngineConfig`` fields, ``device``) to a causal LM exposing
    ``decode_adapter()`` (GPTForCausalLM, LlamaForCausalLM). After this,
    ``text.generation.generate`` / ``generate_padded`` route through the
    engine (the paged-attention kernel K3 on the card); the engine is also
    returned for direct ``submit()`` / ``step()`` / ``run()`` driving.
    ``config`` (the reference's ``inference.Config``) is refused: ``Config``
    and ``Predictor`` are not ported yet (ROADMAP.md §A.9b)."""
    if config is not None:
        raise NotImplementedError(
            "enable_decode_engine(config=...): inference.Config is not "
            "ported yet, see ROADMAP.md §A.9b; pass EngineConfig fields as "
            "keyword arguments")
    engine = DecodeEngine(model, **kw)
    model._decode_engine = engine
    return engine


def disable_decode_engine(model):
    """Detach the engine; generation falls back to the loops."""
    if getattr(model, "_decode_engine", None) is not None:
        model._decode_engine = None


__all__ = ["DecodeEngine", "EngineConfig", "PagePool", "PrefixRegistry",
           "SamplingParams", "disable_decode_engine", "enable_decode_engine",
           "pow2_bucket"]
