"""The AMP gateway of the port (counterpart of the AMP part of
``paddle_tpu/framework/op.py``).

The reference routes every op through one dispatch gateway, ``defop``,
which casts the op's floating-point tensor inputs by the active
``auto_cast`` policy before the op runs. The port has no such gateway:
each op that the reference casts is wrapped here with :func:`amp_op`
under the reference's op name, and model code calls those ops where the
reference calls its own (``tensor.add``, ``tensor.reshape``, ...).

The rule is the reference's (``_amp_cast``): at O1 an op on the white
list runs in the AMP dtype, one on the black list in f32, any other op
as given; at O2 a black op runs in f32 and every other op in the AMP
dtype. ``torch.autocast`` is not used: its op lists compute another
function (it keeps log-softmax and cross entropy in f32 where the
reference runs them in bf16, and it has no custom lists).
"""
from __future__ import annotations

import contextlib
import functools

import torch

#: ops run in the AMP dtype at O1 (reference op names)
AMP_WHITE = set()
#: ops kept in float32 at O1 and O2
AMP_BLACK = set()
#: every op name the port casts under (on a list or on neither)
AMP_OPS = set()


class _AmpState:
    """The active ``auto_cast`` policy; ``paddle_tpu_torch.amp`` sets it."""

    __slots__ = ("enable", "dtype", "level")

    def __init__(self):
        self.enable = False
        self.dtype = torch.bfloat16
        self.level = "O1"


amp_state = _AmpState()


def _amp_cast(opname, *tensors):
    """``tensors`` as the op ``opname`` receives them under the active
    policy: each floating-point tensor cast to the op's dtype, anything
    else (None, integer tensors) as given. Returns a tuple."""
    if not amp_state.enable:
        return tensors
    if amp_state.level == "O2":
        target = torch.float32 if opname in AMP_BLACK else amp_state.dtype
    elif opname in AMP_WHITE:
        target = amp_state.dtype
    elif opname in AMP_BLACK:
        target = torch.float32
    else:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)


def amp_op(opname, amp=None):
    """Decorator: run ``fn`` as the reference's op ``opname``, its
    floating-point tensor arguments (positional and keyword) passed through
    :func:`_amp_cast` first. ``amp`` ``"white"`` / ``"black"`` puts the op
    on that list. The wrapper's ``raw`` is ``fn`` itself, for code that
    never runs under ``auto_cast`` and pays for every host frame (the
    serving adapters)."""
    if amp not in (None, "white", "black"):
        raise ValueError(f"amp must be None, 'white' or 'black', got {amp!r}")

    def deco(fn):
        AMP_OPS.add(opname)
        if amp == "white":
            AMP_WHITE.add(opname)
        elif amp == "black":
            AMP_BLACK.add(opname)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not amp_state.enable:
                return fn(*args, **kwargs)
            keys = list(kwargs)
            vals = list(args) + [kwargs[k] for k in keys]
            idx = [i for i, v in enumerate(vals)
                   if isinstance(v, torch.Tensor) and v.is_floating_point()]
            if idx:
                for i, v in zip(idx, _amp_cast(opname,
                                               *(vals[i] for i in idx))):
                    vals[i] = v
            n = len(args)
            return fn(*vals[:n], **dict(zip(keys, vals[n:])))

        wrapper.op_name = opname
        wrapper.raw = fn
        return wrapper

    return deco


def snapshot():
    """The active policy, lists included, as :func:`policy` restores it."""
    return (amp_state.enable, amp_state.dtype, amp_state.level,
            frozenset(AMP_WHITE), frozenset(AMP_BLACK))


@contextlib.contextmanager
def policy(state):
    """Run under the policy ``state`` (from :func:`snapshot`), then restore
    the one in force before."""
    prev = snapshot()

    def put(s):
        amp_state.enable, amp_state.dtype, amp_state.level = s[:3]
        AMP_WHITE.clear()
        AMP_WHITE.update(s[3])
        AMP_BLACK.clear()
        AMP_BLACK.update(s[4])

    put(state)
    try:
        yield
    finally:
        put(prev)


__all__ = ["AMP_BLACK", "AMP_OPS", "AMP_WHITE", "amp_op", "amp_state",
           "policy", "snapshot"]
