"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout (``nn/functional/attention.py``, ``text/models/gpt.py``,
``inference/engine.py``, ...) so each counterpart sits at the same path.
It imports torch, numpy and the standard library only — never ``jax`` and
nothing of ``paddle_tpu``. Every kernel the reference wrote in Pallas is a
hand-written CUDA kernel here (``ops/cuda/``); its plain PyTorch version
serves CPU tensors only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
``Model`` (``hapi_model.py``) and ``io.DataLoader`` follow the network's
device and the ``places`` / ``device`` given.
"""
from .device import resolve_device
from .framework.io_state import load, save
from .hapi_model import Model

__all__ = ["Model", "load", "resolve_device", "save"]
