"""Numeric-anomaly tooling for mixed precision (counterpart of
``paddle_tpu/amp/debugging.py``): ``TensorCheckerConfig``,
``enable_tensor_checker`` / ``disable_tensor_checker`` /
``current_checker``, ``check_numerics`` and the operator-stats
collection.

The hook is an observer on the port's AMP gateway
(``framework/op.py::set_op_observer``), run after every call of an
``amp_op``, where the reference observes every ``defop``. The port routes
through its gateway only the ops the reference casts under ``auto_cast``
(the models' matmuls, norms, activations, attention, losses, the tensor
API's elementwise and shape ops, the MoE routing), so the stats count
those. Ops the reference dispatches through ``defop`` that the port runs
as plain torch calls outside the gateway, and so never counts: the
initializers' draws, the optimizers' update rules, the collectives, the
RNG draws (dropout masks, Gumbel noise) and the engine's paged-KV writes.
``check_numerics`` is a plain reduction; under the abort mode a non-zero
NaN / Inf count raises, as the reference's does (one host read).
"""
from __future__ import annotations

import contextlib
from enum import Enum
from typing import Optional

import torch

from ..framework import op as _op

__all__ = [
    "DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "check_numerics", "collect_operator_stats",
    "enable_operator_stats_collection", "disable_operator_stats_collection",
]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    """Which ops the checker looks at (``checked_op_list``, empty: all;
    ``skipped_op_list``) and in which ``debug_mode``; the other arguments
    are the reference's and kept as given."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


_CHECKER: Optional[TensorCheckerConfig] = None
_OP_STATS: Optional[dict] = None


def _sync_observer():
    """The gateway observes while stats are collected or a checker is
    on, and costs one test a call otherwise."""
    _op.set_op_observer(
        _observe if _OP_STATS is not None or _CHECKER is not None else None)


def enable_tensor_checker(config: TensorCheckerConfig):
    global _CHECKER
    _CHECKER = config if config.enable else None
    _sync_observer()


def disable_tensor_checker():
    global _CHECKER
    _CHECKER = None
    _sync_observer()


def current_checker() -> Optional[TensorCheckerConfig]:
    return _CHECKER


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """``(num_nan, num_inf, num_zero)`` of ``tensor`` as int64 tensors on
    its device. Under ``CHECK_NAN_INF_AND_ABORT`` a NaN or an Inf raises
    ``FloatingPointError``."""
    num_nan = torch.isnan(tensor).sum()
    num_inf = torch.isinf(tensor).sum()
    num_zero = (tensor == 0).sum()
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        n, i = int(num_nan), int(num_inf)
        if n or i:
            raise FloatingPointError(
                f"check_numerics: {op_type or '<tensor>'} {var_name} has "
                f"{n} NaN and {i} Inf values")
    return num_nan, num_inf, num_zero


def enable_operator_stats_collection():
    global _OP_STATS
    _OP_STATS = {}
    _sync_observer()


def disable_operator_stats_collection():
    """Stop collecting; print and return ``{(op name, dtype): calls}``
    (dtype names as the reference prints them: ``float32``,
    ``bfloat16``, ...)."""
    global _OP_STATS
    stats, _OP_STATS = _OP_STATS or {}, None
    _sync_observer()
    if stats:
        print("<------ operator dtype stats ------>")
        for (name, dtype), n in sorted(stats.items()):
            print(f"  {name:<40} {dtype:<10} calls: {n}")
    return stats


def _observe(op_name: str, outs):
    if _OP_STATS is not None:
        for v in outs:
            key = (op_name, str(v.dtype).replace("torch.", ""))
            _OP_STATS[key] = _OP_STATS.get(key, 0) + 1
    cfg = _CHECKER
    if cfg is not None and (not cfg.checked_op_list
                            or op_name in cfg.checked_op_list) \
            and op_name not in cfg.skipped_op_list:
        for v in outs:
            if v.is_floating_point():
                check_numerics(v, op_type=op_name, debug_mode=cfg.debug_mode)


@contextlib.contextmanager
def collect_operator_stats():
    """Collect the per-op dtype call counts over the block and print them
    on exit."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()
