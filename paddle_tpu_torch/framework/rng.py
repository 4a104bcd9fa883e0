"""The global random state of the port (counterpart of
``paddle_tpu/framework/rng.py``): ``paddle.seed`` and the state getters
over torch's default generators, the CPU's and each CUDA device's. Every
random op of the port that is given no ``torch.Generator`` (dropout, a
layer's init) draws from them."""
from __future__ import annotations

import torch


def seed(value: int) -> torch.Generator:
    """Seed the CPU generator and every CUDA device's (paddle.seed);
    returns the CPU generator."""
    return torch.manual_seed(int(value))


def get_rng_state():
    """The generators' states: the CPU's first, then each CUDA device's
    where CUDA is available."""
    states = [torch.get_rng_state()]
    if torch.cuda.is_available():
        states += torch.cuda.get_rng_state_all()
    return states


def set_rng_state(state):
    """Restore the states :func:`get_rng_state` returned."""
    torch.set_rng_state(state[0])
    if len(state) > 1:
        torch.cuda.set_rng_state_all(state[1:])


__all__ = ["get_rng_state", "seed", "set_rng_state"]
