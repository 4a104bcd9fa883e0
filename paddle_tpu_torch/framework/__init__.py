"""Framework helpers of the port."""
from .io_state import load_numpy_state, state_from_numpy

__all__ = ["load_numpy_state", "state_from_numpy"]
