"""The tensor functions of the port (counterpart of ``paddle_tpu/tensor/``):
creation, logic, random, manipulation, math and linalg's products and
norms, each under the reference's op name so that ``auto_cast`` casts its
inputs as the reference's gateway does (``framework/op.py``). They take
and return ``torch.Tensor``s; Paddle's ``Tensor`` methods are not patched
onto ``torch.Tensor`` (ROADMAP A.9b)."""
import torch as _torch

from . import creation, linalg, logic, manipulation, math, random
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .manipulation import paddle_slice as slice  # noqa: F401,A001
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from ..framework.op import amp_op as _amp_op


@_amp_op("einsum_op")
def _einsum(operands, equation):
    return _torch.einsum(equation, *operands)


def einsum(equation, *operands):
    """paddle.einsum: ``operands`` contracted by ``equation``."""
    return _einsum(list(operands), equation=equation)


__all__ = sorted(set(creation.__all__ + linalg.__all__ + logic.__all__
                     + manipulation.__all__ + math.__all__ + random.__all__
                     + ["einsum", "slice"]))
