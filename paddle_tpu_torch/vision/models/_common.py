"""What the vision families share: the keyword arguments every layer of a
model is built with (its device, dtype and ``torch.Generator``), the
``Linear`` with the reference's XavierNormal weights, and the refusal of
``pretrained=True`` (no weights are bundled)."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import resolve_device
from ...nn import Linear
from ...nn import initializer as I


def layer_kw(device=None, dtype=torch.float32,
             generator: Optional[torch.Generator] = None, seed: int = 0):
    """``dict(device, dtype, generator)`` for every layer of one model:
    ``device`` the CUDA card unless ``"cpu"`` is named, ``generator``
    default a generator on that device seeded with ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return dict(device=dev, dtype=dtype, generator=generator)


def linear(in_features, out_features, **kw):
    """The reference's ``Linear``: XavierNormal weights, zero bias."""
    return Linear(in_features, out_features, weight_init=I.XavierNormal(),
                  **kw)


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (offline build); load a "
            "checkpoint with paddle_tpu_torch.framework.set_state_dict")
