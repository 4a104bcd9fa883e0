"""``paddle.incubate`` counterparts of the port: the MoE layers, the
fused functionals Llama's ops stand on, ``LookAhead`` / ``ModelAverage``
and ``incubate.autograd`` (the reference's alias of ``autograd``)."""
from .. import autograd  # noqa: F401  (as the reference's incubate.autograd)
from .moe import MoELayer, global_gather, global_scatter
from .nn import (FusedEcMoe, fused_ec_moe, fused_rms_norm,
                 fused_rotary_position_embedding, swiglu)
from .optimizer import LookAhead, ModelAverage

__all__ = ["FusedEcMoe", "LookAhead", "MoELayer", "ModelAverage",
           "autograd", "fused_ec_moe", "fused_rms_norm",
           "fused_rotary_position_embedding", "global_gather",
           "global_scatter", "swiglu"]
