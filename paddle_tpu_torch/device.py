"""Device resolution for the PyTorch port (and ``paddle.device``'s
``set_device`` / ``get_device``).

The port runs on an NVIDIA GPU. Every entry point takes a ``device``
argument; ``None`` means the default device, which is the CUDA card until
:func:`set_device` names another, and the CPU is used only when a caller
names it (the CPU tests do). Nothing falls back to the CPU on its own:
asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

#: the device :func:`set_device` chose; None = the current CUDA device
_default: Optional[torch.device] = None


def _cuda(index: Optional[int]) -> torch.device:
    """CUDA device ``index`` (None: the current one); raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; paddle_tpu_torch runs on the GPU "
            "unless device='cpu' is passed explicitly")
    if index is None:
        index = torch.cuda.current_device()
    return torch.device("cuda", index)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` is the default device (:func:`set_device`; the current CUDA
    device until it is called). ``"cuda"`` resolves to the current CUDA
    device; both raise ``RuntimeError`` when CUDA is unavailable.
    ``"cpu"`` is honoured as given. Other device types are refused.
    """
    if device is None:
        return _cuda(None) if _default is None else _default
    dev = torch.device(device)
    if dev.type == "cuda":
        return _cuda(dev.index)
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")


def set_device(device: str) -> torch.device:
    """paddle.set_device: the default device of every entry point from now
    on. ``"gpu"``, ``"gpu:N"``, ``"cuda"`` and ``"cuda:N"`` name CUDA
    device N (0 for ``"gpu"``) and raise when CUDA is unavailable or has
    no such device; ``"cpu"`` names the CPU; anything else raises
    ``ValueError``. Returns the device."""
    global _default
    kind, _, idx = str(device).lower().partition(":")
    if kind in ("gpu", "cuda"):
        dev = _cuda(int(idx) if idx else (0 if kind == "gpu" else None))
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {dev.index}: "
                             f"{torch.cuda.device_count()} visible")
    elif kind == "cpu" and idx in ("", "0"):
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}; expected 'gpu', "
                         "'gpu:N', 'cuda', 'cuda:N' or 'cpu'")
    _default = dev
    return dev


def get_device() -> str:
    """paddle.get_device: ``"gpu:N"`` or ``"cpu"`` for the default device;
    ``"cpu"`` where none was set and CUDA is unavailable."""
    if _default is None and not torch.cuda.is_available():
        return "cpu"
    dev = resolve_device(None)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def host_memory_stats() -> dict:
    """Host staging-arena stats from the native runtime
    (``runtime.host_memory_stats``): the host-side analogue of
    ``paddle.device.cuda.memory_stats``."""
    from . import runtime

    return runtime.host_memory_stats()


__all__ = ["get_device", "host_memory_stats", "resolve_device",
           "set_device"]
