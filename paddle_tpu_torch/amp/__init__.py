"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``).

``auto_cast`` sets the policy that the port's ops read through
``framework/op.py::_amp_cast``: O1 casts the white-listed ops (``linear``,
``sdpa_op``, ``matmul``, ``bmm``) to the AMP dtype and the black-listed
ones (norms, softmax, ``exp``, ``log``) to f32; O2 casts every op but the
black-listed ones to the AMP dtype. ``decorate`` turns a model's f32
parameters to the AMP dtype in place and makes the optimizer keep f32
moments (``multi_precision``). ``GradScaler`` is the reference's dynamic
loss scaling, mirrored as written: it scales under bf16 too.

bf16 is the default dtype. fp16 follows the same rules, but the port's
attention kernels take f32 and bf16 only, so an fp16 model raises on the
card (the plain versions serve CPU tensors).
"""
from __future__ import annotations

import contextlib

import torch

from ..framework.op import AMP_BLACK, AMP_WHITE, amp_state
# the modules whose ops declare the lists
from ..nn import functional as _functional  # noqa: F401
from .. import tensor as _tensor  # noqa: F401

__all__ = ["GradScaler", "amp_guard", "auto_cast", "autocast", "black_list",
           "decorate", "is_bfloat16_supported", "is_float16_supported",
           "white_list"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {tuple(_DTYPES)}, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Run the block under AMP at ``level`` (``"O0"`` turns it off).
    ``custom_white_list`` / ``custom_black_list`` add op names to the
    lists for the block only."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError("level must be O0/O1/O2")
    dt = _dtype(dtype)
    prev = (amp_state.enable, amp_state.dtype, amp_state.level)
    added_w = set(custom_white_list or ()) - AMP_WHITE
    added_b = set(custom_black_list or ()) - AMP_BLACK
    AMP_WHITE.update(added_w)
    AMP_BLACK.update(added_b)
    amp_state.enable = bool(enable) and level != "O0"
    amp_state.dtype = dt
    amp_state.level = level
    try:
        yield
    finally:
        amp_state.enable, amp_state.dtype, amp_state.level = prev
        AMP_WHITE.difference_update(added_w)
        AMP_BLACK.difference_update(added_b)


autocast = auto_cast
amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every f32 parameter of ``models`` to ``dtype`` in place
    (the ``Parameter`` objects stay, so an optimizer's list and a tied
    head stay bound; buffers are left alone) and set each optimizer's
    ``_multi_precision`` (f32 moments; ``master_weight`` False clears
    it). Other levels change nothing. Returns what it was given."""
    dt = _dtype(dtype)
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(dt)
        if optimizers is not None:
            opt_list = list(optimizers) \
                if isinstance(optimizers, (list, tuple)) else [optimizers]
            for o in opt_list:
                o._multi_precision = (True if master_weight is None
                                      else bool(master_weight))
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (the reference's ``GradScaler``): ``scale``
    multiplies the loss by the scale whenever enabled, whatever the AMP
    dtype, as the reference's code does; ``step`` unscales the gradients,
    and skips the optimizer step if any is not finite; ``update`` halves
    the scale after ``decr_every_n_nan_or_inf`` such steps (not below 1)
    and doubles it after ``incr_every_n_steps`` good ones.

    ``unscale_`` keeps one non-finite flag on the device over all the
    gradients; ``step`` reads it once."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place; the non-finite flag
        stays a device tensor until :meth:`step` reads it."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad.mul_(inv)
                flags.append(torch.isfinite(p.grad).all())
        self._found_inf = (torch.stack(flags).logical_not().any()
                           if flags else False)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        self._found_inf = bool(self._found_inf)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def is_float16_supported(device=None):
    """Whether ``device`` (default the CUDA card) computes in float16: the
    CPU does; a CUDA card from compute capability 5.3. The port's attention
    kernels still take f32 and bf16 only."""
    return _supported(device, (5, 3))


def is_bfloat16_supported(device=None):
    """Whether ``device`` (default the CUDA card) computes in bfloat16: the
    CPU does; a CUDA card from compute capability 8.0."""
    return _supported(device, (8, 0))


def _supported(device, capability):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) >= capability


def white_list():
    """The ops computed in the low-precision dtype, keyed as the reference
    keys them (``{dtype: {level: set}}``); every entry is a copy."""
    return {dt: {lv: set(AMP_WHITE) for lv in ("O1", "O2")}
            for dt in ("float16", "bfloat16")}


def black_list():
    """The ops kept in float32, keyed as :func:`white_list`."""
    return {dt: {lv: set(AMP_BLACK) for lv in ("O1", "O2")}
            for dt in ("float16", "bfloat16")}


from . import debugging  # noqa: E402,F401  (paddle.amp.debugging)
