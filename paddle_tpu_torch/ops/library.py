"""The ops that ``torch.export`` records in place of a kernel wrapper.

A kernel wrapper launches through ``ctypes`` on ``data_ptr()``, which a
traced (fake) tensor does not have, and it picks its route by the
tensor's device while it runs. A program exported through it would hold
either a failed trace or the plain version's einsums. So while a trace
is recording (``torch.export``, or any trace on fake tensors), the model
code calls the op registered here instead: the graph then holds one
``paddle_tpu::attention`` node per attention, and the implementation is
chosen when the loaded program runs, by the device its tensors are on:

* CUDA tensors: flash attention through K1
  (``ops/flash_attention.py::flash_attention``, ``ops/cuda/
  flash_attention.cu::flash_fwd_kernel``), or it raises. The op never runs
  the plain version, the CPU or a library call on the card;
* CPU tensors: the route that an eager CPU call takes
  (``nn/functional/attention.py::_attend_cpu``);
* fake tensors: an empty result of q's shape and dtype.

The op is forward only (dropout 0): a program is exported in eval mode.
``mask`` is a bool keep-mask or an additive float mask broadcastable to
``[B, H, Tq, Tk]``; ``scale`` None is ``1 / sqrt(D)``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor


def recording(x: torch.Tensor) -> bool:
    """True while a trace records ``x``'s computation: under
    ``torch.export``, or when ``x`` is a fake tensor."""
    return torch.compiler.is_exporting() or isinstance(x, FakeTensor)


@torch.library.custom_op("paddle_tpu::attention", mutates_args=(),
                         device_types="cpu")
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], causal: bool,
              scale: Optional[float]) -> torch.Tensor:
    """Attention over ``[B, T, H, D]`` q / k / v; returns a contiguous
    ``[B, Tq, H, D]`` tensor in q's dtype. This body serves CPU tensors."""
    from ..nn.functional.attention import _attend_cpu

    return _attend_cpu(q, k, v, mask, causal, scale).contiguous()


@attention.register_kernel("cuda")
def _attention_cuda(q, k, v, mask, causal, scale):
    from ..nn.functional.attention import _flash

    return _flash(q, k, v, mask, causal, scale).contiguous()


@attention.register_fake
def _attention_fake(q, k, v, mask, causal, scale):
    return q.new_empty(q.shape)


__all__ = ["attention", "recording"]
