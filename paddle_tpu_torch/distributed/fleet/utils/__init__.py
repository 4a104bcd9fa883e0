"""``fleet.utils`` counterparts: activation recompute, sequence
parallelism, the hybrid-parallel synchronisation helpers and the
mixed-precision wrappers."""
from . import mix_precision_utils  # noqa: F401
from .recompute_helper import (policy_for_granularity, recompute,
                               recompute_hybrid, recompute_sequential)
from . import sequence_parallel_utils  # noqa: F401
from . import hybrid_parallel_util  # noqa: F401

__all__ = ["hybrid_parallel_util", "mix_precision_utils",
           "policy_for_granularity", "recompute",
           "recompute_hybrid", "recompute_sequential",
           "sequence_parallel_utils"]
