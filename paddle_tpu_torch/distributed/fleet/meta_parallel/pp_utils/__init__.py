"""Pipeline helpers (upstream Paddle's ``fleet/meta_parallel/pp_utils``)."""
from .p2p_communication import P2pHelper  # noqa: F401
