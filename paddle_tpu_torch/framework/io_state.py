"""State bridge: parameters of the reference package, handed over as numpy
arrays by name, become the port's state_dict (names and shapes are the
same on both sides, see ``nn/layers/common.py``)."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def state_from_numpy(np_state: Mapping[str, np.ndarray], device,
                     dtype: Optional[torch.dtype] = None, *,
                     expected: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Convert ``{name: ndarray}`` into ``{name: tensor}`` on ``device``
    (cast to ``dtype`` when given). With ``expected`` (a module's
    ``state_dict()``), raise ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape mismatch."""
    if expected is not None:
        missing = sorted(set(expected) - set(np_state))
        extra = sorted(set(np_state) - set(expected))
        if missing or extra:
            raise KeyError(f"state names differ: missing {missing}, "
                           f"unexpected {extra}")
        for name, ref in expected.items():
            got = tuple(np.shape(np_state[name]))
            if got != tuple(ref.shape):
                raise ValueError(f"{name}: shape {got} != expected "
                                 f"{tuple(ref.shape)}")
    out = {}
    for name, arr in np_state.items():
        out[name] = torch.tensor(np.asarray(arr), device=device,
                                 dtype=dtype)
    return out


def load_numpy_state(module: torch.nn.Module,
                     np_state: Mapping[str, np.ndarray]):
    """Load the reference's state, given as ``{name: ndarray}``, into
    ``module`` on its device and in its dtypes; names and shapes must
    match ``module.state_dict()`` exactly. Returns ``module``."""
    ref = module.state_dict()
    dev = next(iter(ref.values())).device
    state = state_from_numpy(np_state, dev, expected=ref)
    module.load_state_dict(
        {k: v.to(ref[k].dtype) for k, v in state.items()}, strict=True)
    return module
