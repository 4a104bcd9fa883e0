"""Framework helpers of the port."""
from .io_state import (load, load_numpy_state, save, set_state_dict,
                       state_from_numpy)

__all__ = ["load", "load_numpy_state", "save", "set_state_dict",
           "state_from_numpy"]
