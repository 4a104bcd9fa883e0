"""``paddle.incubate`` counterparts of the port: the MoE layers."""
from .moe import MoELayer
from .nn import FusedEcMoe, fused_ec_moe

__all__ = ["FusedEcMoe", "MoELayer", "fused_ec_moe"]
