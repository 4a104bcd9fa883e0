"""The quantized tensor-parallel (activation) wire (counterpart of
``paddle_tpu/distributed/mp_comm.py``), the mp analogue of the gradient
wire in ``grad_comm``.

The reference restructures each mp contraction with an explicit block
dim carrying the per-shard f32 partial sums, quantizes them per (row,
block) (int8 with absmax scales, or bf16), gathers them in the wire dtype
and sums the dequantized blocks in f32. Here each rank holds its shard,
so a partial sum is the rank's own: :func:`wire_sum` quantizes it per row
(one absmax scale a row for int8), all-gathers the payload in the wire
dtype (int8 beside the f32 scales, or bf16) over the mp group and sums the
dequantized partials in f32 in rank order:

- :func:`row_parallel_matmul`: the forward sum of a row-parallel product
  (``RowParallelLinear``) through the wire; the backward is
  straight-through, the cotangent round-tripped through the wire
  (``grad_comm.quantize_roundtrip``, one scale for the whole cotangent);
- :func:`column_parallel_linear`: a column-parallel product whose input's
  gradient (the layer's one mp collective, the sum of the ranks' partial
  ``dx``) goes through the wire; the forward and ``dw`` are exact;
- :func:`vocab_parallel_embedding`: the sum of the ranks' masked lookups
  through the wire, straight-through in the backward.

``fleet/layers/mpu.py`` routes ``RowParallelLinear``,
``ColumnParallelLinear``, ``VocabParallelEmbedding`` and a tied LM head
through them when the wire is on (``mp_comm`` with a bf16 / int8
``wire_dtype``) and the mp degree is above 1; otherwise those layers
compute exactly what they compute without it. ``collective.counts``
adds up ``mp_wire_bytes`` (the payload and scales each rank sends) and
``mp_wire_f32_bytes`` (the ring all-reduce of f32 it replaces), as the
reference's ``_record_site`` prices them.

:func:`quantized_logit_gather` replicates vocab-parallel logits through
the wire with an exact (max, argmax) side channel, and
:func:`logit_wire_bytes` prices it; ``inference/engine.py`` recombines
its mp-sharded logits through it (``EngineConfig.logit_wire``).

Config: ``DistributedStrategy.mp_comm`` / ``mp_comm_configs``, overridden
by ``PADDLE_TPU_MP_COMM`` (``grad_comm.parse_wire_env``'s grammar with the
keys ``ef`` / ``error_feedback``, ``zero_gather``, ``verify`` /
``logit_verify``). :func:`activation_wire_disabled` turns the wire off
for what runs inside. ``zero_gather`` (the reference's bf16 ZeRO-3
parameter gather inside its explicit data-parallel region) has no
counterpart: the port's ZeRO-3 gathers in f32, as the reference's
GSPMD path does.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from . import collective as C
from .grad_comm import (WIRE_DTYPES, _bool_key, parse_wire_env,
                        quantize_absmax, quantize_roundtrip)


@dataclass(frozen=True)
class MpCommConfig:
    """Resolved activation-wire knobs (the reference's fields)."""

    enable: bool = False
    wire_dtype: str = "f32"
    error_feedback: bool = False
    zero_gather: bool = True
    logit_verify: bool = True

    @property
    def quantized(self) -> bool:
        return self.enable and self.wire_dtype in ("bf16", "int8")

    @property
    def act_wire(self) -> Optional[str]:
        return self.wire_dtype if self.quantized else None

    @property
    def param_gather_wire(self) -> Optional[str]:
        return "bf16" if self.quantized and self.zero_gather else None

    @property
    def wire_itemsize(self) -> int:
        return {"f32": 4, "bf16": 2, "int8": 1}[self.wire_dtype]


_TLS = threading.local()


@contextlib.contextmanager
def activation_wire_disabled():
    """Within: the activation wire is off, whatever the config says."""
    prev = getattr(_TLS, "disabled", False)
    _TLS.disabled = True
    try:
        yield
    finally:
        _TLS.disabled = prev


def _strategy_config(strategy) -> MpCommConfig:
    cfg = MpCommConfig()
    if strategy is None:
        return cfg
    sub = dict(getattr(strategy, "mp_comm_configs", {}) or {})
    wire = str(sub.get("wire_dtype", cfg.wire_dtype)).lower()
    if wire not in WIRE_DTYPES:
        raise ValueError(
            f"mp_comm_configs.wire_dtype={wire!r} not in {WIRE_DTYPES}")
    return replace(
        cfg, enable=bool(getattr(strategy, "mp_comm", False)),
        wire_dtype=wire,
        error_feedback=bool(sub.get("error_feedback", cfg.error_feedback)),
        zero_gather=bool(sub.get("zero_gather", cfg.zero_gather)),
        logit_verify=bool(sub.get("logit_verify", cfg.logit_verify)))


def resolve_config(strategy=None) -> MpCommConfig:
    """The strategy's knobs (the fleet strategy's when None), overridden
    by ``PADDLE_TPU_MP_COMM``; all off inside
    :func:`activation_wire_disabled`."""
    if getattr(_TLS, "disabled", False):
        return MpCommConfig()
    if strategy is None:
        from .fleet import fleet_strategy

        strategy = fleet_strategy()
    var = "PADDLE_TPU_MP_COMM"
    return parse_wire_env(var, _strategy_config(strategy), {
        "ef": _bool_key(var, "error_feedback"),
        "error_feedback": _bool_key(var, "error_feedback"),
        "zero_gather": _bool_key(var, "zero_gather"),
        "verify": _bool_key(var, "logit_verify"),
        "logit_verify": _bool_key(var, "logit_verify"),
    })


# ------------------------------------------------------------ the exchange --
def wire_sum(z, wire_dtype: str, group):
    """The sum over ``group`` of each rank's ``z [..., K]`` through the wire
    (no autograd): quantized per row (int8: an absmax scale a row; bf16),
    gathered in the wire dtype, dequantized and summed in f32 in rank
    order. Returns f32."""
    n = group.nranks
    z = z.float()
    if wire_dtype == "int8":
        q, scale = quantize_absmax(z, axis=-1)
        parts = C.stacked_all_gather(q, group).float() \
            * C.stacked_all_gather(scale, group)
        scale_bytes = scale.numel() * 4
    elif wire_dtype == "bf16":
        parts = C.stacked_all_gather(z.to(torch.bfloat16), group)
        scale_bytes = 0
    else:
        raise ValueError(f"wire_dtype {wire_dtype!r} is not a quantized "
                         "wire (bf16 / int8)")
    out = C.rank_order_sum(parts)
    it = {"bf16": 2, "int8": 1}[wire_dtype]
    C.counts["mp_wire_bytes"] += (n - 1) * (z.numel() * it + scale_bytes)
    C.counts["mp_wire_f32_bytes"] += int(2 * (n - 1) * z.numel() * 4 / n)
    return out


class _WireSum(torch.autograd.Function):
    """The forward sum through the wire; straight-through backward with the
    cotangent round-tripped through the wire."""

    @staticmethod
    def forward(ctx, z, wire_dtype, group):
        ctx.wire = wire_dtype
        ctx.dtype = z.dtype
        return wire_sum(z, wire_dtype, group)

    @staticmethod
    def backward(ctx, ct):
        return (quantize_roundtrip(ct.float(), ctx.wire).to(ctx.dtype),
                None, None)


class _WireIdentity(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients through the
    wire (a column-parallel product's input)."""

    @staticmethod
    def forward(ctx, x, wire_dtype, group):
        ctx.wire, ctx.group = wire_dtype, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (wire_sum(g, ctx.wire, ctx.group).to(g.dtype), None, None)


def wire_identity(x, wire_dtype, group):
    """``x``, its gradient summed over ``group`` through the wire."""
    return _WireIdentity.apply(x, wire_dtype, group)


def wire_allreduce(z, wire_dtype, group):
    """The sum of every rank's ``z`` over ``group`` through the wire, in
    ``z``'s dtype; its gradient passes straight through."""
    return _WireSum.apply(z, wire_dtype, group).to(z.dtype)


def row_parallel_matmul(x, w, wire_dtype: str, group):
    """``x [..., I / mp] @ w [I / mp, O]`` summed over ``group`` through the
    wire (the reference's blocked row-parallel contraction). Returns
    ``x``'s dtype promoted with ``w``'s."""
    return wire_allreduce(torch.matmul(x, w), wire_dtype, group)


def column_parallel_linear(x, w, wire_dtype: str, group):
    """``x @ w[:, shard]``: collective-free forward, the input's gradient
    summed over ``group`` through the wire."""
    return torch.matmul(wire_identity(x, wire_dtype, group), w)


def vocab_parallel_embedding(w, ids, start, wire_dtype: str, group):
    """The lookup of global ``ids`` in this rank's vocab rows ``w [V / mp,
    H]`` (rows from ``start``; ids outside look up 0), summed over
    ``group`` through the wire."""
    local = ids - start
    outside = (local < 0) | (local >= w.shape[0])
    z = torch.nn.functional.embedding(torch.where(outside, 0, local), w)
    return wire_allreduce(z.masked_fill(outside.unsqueeze(-1), 0.0),
                          wire_dtype, group)


# ------------------------------------------------ decode logit recombination
def quantized_logit_gather(logits, wire_dtype: str, group=None):
    """Replicate vocab-parallel ``logits [..., V / mp]`` (this rank's vocab
    block) through the wire with an exact side channel: returns
    ``(wire_logits [..., V] f32, exact_argmax [...] int32)``, the
    argmax that of the exact logits (each block's max and first argmax
    gathered exactly, the first maximal block wins), or None without an
    mp group of more than one rank or with an f32 wire. The bytes this
    rank sends add to ``collective.counts["logit_wire_bytes"]`` (what
    :func:`logit_wire_bytes` prices)."""
    if group is None:
        from .fleet.layers.mpu import _mp_group

        group = _mp_group()[0]
    if group is None or group.nranks <= 1 or \
            wire_dtype not in ("bf16", "int8"):
        return None
    lf = logits.float()
    vg = lf.shape[-1]
    sent = []

    def gather(x):
        sent.append(x.numel() * x.element_size())
        return C.stacked_all_gather(x, group)

    bmax = gather(lf.amax(-1))                                 # [g, ...]
    barg = gather(lf.argmax(-1).to(torch.int32))
    win = torch.argmax(bmax, dim=0)                       # first max block
    exact = (win * vg + torch.gather(barg, 0, win.unsqueeze(0))[0]).to(
        torch.int32)
    if wire_dtype == "int8":
        q, scale = quantize_absmax(lf, axis=-1)
        parts = gather(q).float() * gather(scale)
    else:
        parts = gather(lf.to(torch.bfloat16)).float()
    C.counts["logit_wire_bytes"] += (group.nranks - 1) * sum(sent)
    wire = torch.cat(list(parts), dim=-1)
    return wire, exact


def logit_wire_bytes(rows: int, vocab: int, g: int,
                     wire_dtype: str) -> Tuple[float, float]:
    """The reference's price of one logit recombination: ``(f32 baseline
    bytes, wire bytes)`` for ``rows`` rows (the wire counts the payload,
    int8's f32 scales and the exact (max, argmax) exchange)."""
    it = {"f32": 4, "bf16": 2, "int8": 1}[wire_dtype]
    frac = (g - 1) / g
    base = frac * rows * vocab * 4.0
    if wire_dtype == "f32":
        return base, base
    wire = frac * rows * vocab * it + frac * rows * g * 8.0
    if wire_dtype == "int8":
        wire += frac * rows * g * 4.0
    return base, wire


__all__ = ["MpCommConfig", "activation_wire_disabled",
           "column_parallel_linear", "logit_wire_bytes",
           "quantized_logit_gather", "resolve_config", "row_parallel_matmul",
           "vocab_parallel_embedding", "wire_allreduce", "wire_identity",
           "wire_sum"]
