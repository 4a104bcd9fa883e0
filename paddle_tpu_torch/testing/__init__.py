"""paddle_tpu_torch.testing — fault-injection and robustness test
utilities (counterpart of ``paddle_tpu/testing``).

``paddle_tpu_torch.testing.chaos`` is the deterministic fault-injection
harness (process kills, torn / corrupted checkpoint writes, store and
network faults) driven by PADDLE_CHAOS_* env knobs.
"""
from . import chaos

__all__ = ["chaos"]
