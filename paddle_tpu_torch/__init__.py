"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout (``nn/functional/attention.py``, ``text/models/gpt.py``,
``inference/engine.py``, ...) so each counterpart sits at the same path.
It imports torch, numpy and the standard library only — never ``jax`` and
nothing of ``paddle_tpu``. Every kernel the reference wrote in Pallas is a
hand-written CUDA kernel here (``ops/cuda/``); its plain PyTorch version
serves CPU tensors only.

``import paddle_tpu_torch as paddle`` gives the reference's top-level
names that the port has: the subpackages, the dtype names (as
``torch.dtype``), the tensor functions (``paddle.slice``, ``einsum``,
``paddle.linalg`` among them), ``seed`` and the RNG state,
``to_tensor``, ``set_device`` / ``get_device``, the grad switches,
``grad`` (``autograd.grad``),
``Model``, ``DataParallel``, ``save`` / ``load``, ``profiler`` and
``callbacks`` (``hapi/callbacks.py``); ``jit`` / ``static`` /
``inference`` save a model and serve it (``jit.save`` ->
``inference.create_predictor``).

Entry points run on the default device: the CUDA card, unless
``set_device("cpu")`` was called or the caller passes ``device="cpu"``;
``Model`` (``hapi_model.py``) and ``io.DataLoader`` follow the network's
device and the ``places`` / ``device`` given.
"""
import torch as _torch

from . import (amp, autograd, device, distributed, incubate, inference, io,
               jit, metric, nn, optimizer, profiler, static, tensor, text,
               vision)
from .device import get_device, resolve_device, set_device
from .distributed.parallel import DataParallel
from .framework.io_state import load, save
from .framework.rng import get_rng_state, seed, set_rng_state
from .hapi import callbacks
from .hapi_model import Model
from .tensor import *  # noqa: F401,F403  (the tensor functions)
from .tensor import linalg  # noqa: F401  (paddle.linalg)

def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False):
    """paddle.grad: :func:`autograd.grad`."""
    return autograd.grad(outputs, inputs, grad_outputs, retain_graph,
                         create_graph, allow_unused=allow_unused)


no_grad = _torch.no_grad
enable_grad = _torch.enable_grad
set_grad_enabled = _torch.set_grad_enabled
is_grad_enabled = _torch.is_grad_enabled

# dtype names (paddle.float32, ...), those of framework/dtype.py
bool = _torch.bool  # noqa: A001 — paddle exposes ``paddle.bool``
uint8 = _torch.uint8
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
float16 = _torch.float16
bfloat16 = _torch.bfloat16
float32 = _torch.float32
float64 = _torch.float64
complex64 = _torch.complex64
complex128 = _torch.complex128

__all__ = (["DataParallel", "Model", "amp", "autograd", "callbacks",
            "device", "distributed", "enable_grad", "get_device", "grad",
            "get_rng_state", "incubate", "inference", "io",
            "is_grad_enabled", "jit", "linalg", "load", "metric", "nn",
            "no_grad", "optimizer", "profiler", "resolve_device", "save",
            "seed", "set_device", "set_grad_enabled", "set_rng_state",
            "static", "tensor", "text", "vision", "bool", "uint8", "int8",
            "int16", "int32", "int64", "float16", "bfloat16", "float32",
            "float64", "complex64", "complex128"]
           + list(tensor.__all__))
