"""``paddle.incubate`` counterparts of the port: the MoE layers and the
fused functionals Llama's ops stand on."""
from .moe import MoELayer
from .nn import (FusedEcMoe, fused_ec_moe, fused_rms_norm,
                 fused_rotary_position_embedding, swiglu)

__all__ = ["FusedEcMoe", "MoELayer", "fused_ec_moe", "fused_rms_norm",
           "fused_rotary_position_embedding", "swiglu"]
