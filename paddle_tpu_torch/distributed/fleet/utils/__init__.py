"""``fleet.utils`` counterparts: activation recompute."""
from .recompute_helper import policy_for_granularity, recompute

__all__ = ["policy_for_granularity", "recompute"]
