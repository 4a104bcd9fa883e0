"""Framework helpers of the port."""
from .io_state import state_from_numpy

__all__ = ["state_from_numpy"]
