"""Device resolution for the PyTorch port.

The port runs on an NVIDIA GPU. Every entry point takes a ``device``
argument; ``None`` means the CUDA card, and the CPU is used only when a
caller names it (the CPU tests do). Nothing falls back to the CPU on its
own: asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` and ``"cuda"`` resolve to the current CUDA device and raise
    ``RuntimeError`` when CUDA is unavailable; ``"cpu"`` is honoured as
    given. Other device types are refused.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; paddle_tpu_torch runs on the GPU "
                "unless device='cpu' is passed explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")

