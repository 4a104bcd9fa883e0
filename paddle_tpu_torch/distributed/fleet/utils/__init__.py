"""``fleet.utils`` counterparts: activation recompute, sequence
parallelism and the hybrid-parallel synchronisation helpers."""
from .recompute_helper import (policy_for_granularity, recompute,
                               recompute_hybrid, recompute_sequential)
from . import sequence_parallel_utils  # noqa: F401
from . import hybrid_parallel_util  # noqa: F401

__all__ = ["hybrid_parallel_util", "policy_for_granularity", "recompute",
           "recompute_hybrid", "recompute_sequential",
           "sequence_parallel_utils"]
