"""Gradient communication: bucketing and the f32 exchange, and the absmax
int8 helpers (counterpart of ``paddle_tpu/distributed/grad_comm.py``).

Gradients cross the data-parallel group in flat buffers ("buckets") of
about ``bucket_mb`` MiB each: :func:`build_buckets` groups the tensors in
their given order (reference :232), :func:`make_layouts` records each
bucket's offsets, :func:`pack_bucket` / :func:`unpack_bucket` concatenate
and split (reference :253-310). :func:`allreduce_mean` all-reduces each
bucket over a group and divides it by the group's size;
:func:`allreduce_sum` leaves the sum (a pipeline's replicated
parameters, over the pipe group). The bucket size
is ``DistributedStrategy.fuse_grad_size_in_MB`` (32 by default), or
``grad_comm_configs["bucket_mb"]``, overridden by the environment
variable ``PADDLE_TPU_GRAD_COMM`` (see :func:`resolve_config`).

Only the f32 wire is ported: a ``bf16`` / ``int8`` ``wire_dtype`` raises
in ``fleet.init`` (ROADMAP.md §A.7). The serving engine's int8 KV pool
uses :func:`quantize_absmax` with the head_dim axis.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch

WIRE_DTYPES = ("f32", "bf16", "int8")

_INT8_LEVELS = 127.0


@dataclass(frozen=True)
class GradCommConfig:
    """Resolved gradient-communication knobs, the reference's fields and
    grammar. The port acts on ``bucket_mb`` and ``wire_dtype`` (f32 only);
    ``error_feedback`` belongs to the quantized wire, ``overlap`` and
    ``pipeline_batch_shard`` to exchanges the port does not have yet
    (ROADMAP.md §A.7), and ZeRO here shards by parameter whatever
    ``zero_update`` says."""

    enable: bool = False
    bucket_mb: float = 32.0
    wire_dtype: str = "f32"
    error_feedback: bool = False
    zero_update: bool = True
    pipeline_batch_shard: bool = True
    overlap: bool = True

    @property
    def quantized(self) -> bool:
        return self.wire_dtype != "f32"


_TRUE = {"1", "on", "true", "yes"}
_FALSE = {"0", "off", "false", "no"}


def _strategy_config(strategy) -> GradCommConfig:
    cfg = GradCommConfig()
    if strategy is None:
        return cfg
    sub = dict(getattr(strategy, "grad_comm_configs", {}) or {})
    wire = str(sub.get("wire_dtype", cfg.wire_dtype)).lower()
    if wire not in WIRE_DTYPES:
        raise ValueError(
            f"grad_comm_configs.wire_dtype={wire!r} not in {WIRE_DTYPES}")
    default_mb = float(getattr(strategy, "fuse_grad_size_in_MB",
                               cfg.bucket_mb) or cfg.bucket_mb)
    return replace(
        cfg,
        enable=bool(getattr(strategy, "grad_comm", False)),
        bucket_mb=float(sub.get("bucket_mb", default_mb)),
        wire_dtype=wire,
        error_feedback=bool(sub.get("error_feedback", cfg.error_feedback)),
        zero_update=bool(sub.get("zero_update", cfg.zero_update)),
        pipeline_batch_shard=bool(
            sub.get("pipeline_batch_shard", cfg.pipeline_batch_shard)),
        overlap=bool(sub.get("overlap", cfg.overlap)),
    )


def _parse_bool(env_var: str, key: str, v: str) -> bool:
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"{env_var}: {key}={v!r} is not a boolean "
                     f"(want one of {tuple(sorted(_TRUE | _FALSE))})")


_BOOL_KEYS = {"ef": "error_feedback", "error_feedback": "error_feedback",
              "zero": "zero_update", "zero_update": "zero_update",
              "batch_shard": "pipeline_batch_shard",
              "pipeline_batch_shard": "pipeline_batch_shard",
              "overlap": "overlap", "enable": "enable"}


def resolve_config(strategy=None) -> GradCommConfig:
    """The strategy's knobs (the fleet strategy's when None), overridden
    by ``PADDLE_TPU_GRAD_COMM``: ``off`` / ``on`` / ``f32`` / ``bf16`` /
    ``int8`` and comma-separated ``k=v`` (``wire``, ``bucket_mb``, ``ef``,
    ``zero``, ``batch_shard``, ``overlap``, ``enable``), the reference's
    grammar; anything else raises."""
    if strategy is None:
        from .fleet import fleet_strategy

        strategy = fleet_strategy()
    cfg = _strategy_config(strategy)
    var = "PADDLE_TPU_GRAD_COMM"
    raw = os.environ.get(var, "").strip().lower()
    for part in filter(None, (s.strip() for s in raw.split(","))):
        if "=" not in part:
            if part in _FALSE:
                cfg = replace(cfg, enable=False)
            elif part in _TRUE or part == "f32":
                cfg = replace(cfg, enable=True, wire_dtype="f32")
            elif part in ("bf16", "int8"):
                cfg = replace(cfg, enable=True, wire_dtype=part)
            else:
                raise ValueError(f"{var}: bad token {part!r}")
            continue
        k, v = (s.strip() for s in part.split("=", 1))
        if k in ("wire", "wire_dtype"):
            if v not in WIRE_DTYPES:
                raise ValueError(f"{var} wire={v!r} not in {WIRE_DTYPES}")
            cfg = replace(cfg, wire_dtype=v, enable=True)
        elif k == "bucket_mb":
            cfg = replace(cfg, bucket_mb=float(v), enable=True)
        elif k in _BOOL_KEYS:
            cfg = replace(cfg, **{_BOOL_KEYS[k]: _parse_bool(var, k, v)})
        else:
            raise ValueError(f"{var}: unknown key {k!r}")
    return cfg


# --------------------------------------------------------------- bucketing --
def build_buckets(sizes_bytes: Sequence[int],
                  target_bytes: int) -> List[List[int]]:
    """Greedy, order-preserving grouping of tensor indices into buckets of
    about ``target_bytes``: a bucket closes before the tensor that would
    take it past the target (a tensor larger than the target is a bucket
    of its own)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, sz in enumerate(sizes_bytes):
        if cur and cur_bytes + int(sz) > target_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += int(sz)
    if cur:
        buckets.append(cur)
    return buckets


@dataclass(frozen=True)
class BucketLayout:
    """Static layout of one flat fusion buffer: which leaves, where."""

    indices: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int


def make_layouts(shapes: Sequence[Tuple[int, ...]], itemsizes: Sequence[int],
                 target_bytes: int, *, lead_dims: int = 0,
                 indices: Optional[Sequence[int]] = None
                 ) -> List[BucketLayout]:
    """Bucket tensors of ``shapes`` into flat-buffer layouts. With
    ``lead_dims`` the leading dims are kept by pack / unpack and offsets
    count elements per lead slice. ``indices`` relabels position ``j`` to
    a caller index."""
    full = [math.prod(s) for s in shapes]
    flat = [math.prod(s[lead_dims:]) for s in shapes]
    out = []
    for g in build_buckets([n * it for n, it in zip(full, itemsizes)],
                           target_bytes):
        offs, off = [], 0
        for j in g:
            offs.append(off)
            off += flat[j]
        out.append(BucketLayout(
            indices=tuple(indices[j] if indices is not None else j
                          for j in g),
            shapes=tuple(tuple(shapes[j]) for j in g),
            offsets=tuple(offs),
            sizes=tuple(flat[j] for j in g),
            total=off))
    return out


def pack_bucket(leaves, layout: BucketLayout, *, lead_dims: int = 0):
    """``leaves[i]`` for i in the layout, concatenated into one buffer (the
    ``lead_dims`` leading dims kept, the rest flattened)."""
    parts = []
    for i in layout.indices:
        v = leaves[i]
        parts.append(v.reshape(tuple(v.shape[:lead_dims]) + (-1,)))
    return torch.cat(parts, dim=lead_dims)


def unpack_bucket(bucket, layout: BucketLayout, *, lead_dims: int = 0):
    """Inverse of :func:`pack_bucket`: ``[(index, leaf view), ...]``."""
    lead = tuple(bucket.shape[:lead_dims])
    return [(i, bucket.narrow(lead_dims, off, n).reshape(
                lead + tuple(shape[lead_dims:])))
            for i, off, n, shape in zip(layout.indices, layout.offsets,
                                        layout.sizes, layout.shapes)]


def allreduce_mean(tensors, group, bucket_mb=32.0):
    """Average ``tensors`` over ``group`` in place: each bucket of about
    ``bucket_mb`` MiB (tensors grouped by dtype, in order) is packed,
    all-reduced, divided by the group's size and unpacked. Returns the
    number of buckets."""
    return _allreduce_buckets(tensors, group, bucket_mb, average=True)


def allreduce_sum(tensors, group, bucket_mb=32.0):
    """Sum ``tensors`` over ``group`` in place, bucketed as
    :func:`allreduce_mean`. Returns the number of buckets."""
    return _allreduce_buckets(tensors, group, bucket_mb, average=False)


def _allreduce_buckets(tensors, group, bucket_mb, average):
    from . import collective as C

    tensors = [t for t in tensors if t is not None]
    n = 0
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        layouts = make_layouts([tuple(t.shape) for t in same],
                               [t.element_size() for t in same],
                               max(int(bucket_mb * (1 << 20)), 1))
        for lay in layouts:
            flat = pack_bucket(same, lay)
            C.all_reduce(flat, group=group)
            if average:
                flat.div_(group.nranks)
            for i, v in unpack_bucket(flat, lay):
                same[i].copy_(v)
        n += len(layouts)
    return n


# ------------------------------------------------------- int8 quantization --
def quantize_absmax(v, axis=None):
    """Symmetric int8 quantization with an absmax scale over ``axis``
    (``None`` = one scale for the whole tensor). Returns
    ``(q_int8, scale_f32)``; ``scale`` keeps the reduced dims. Rounds half
    to even, as the reference does."""
    vf = v.float()
    if axis is None:
        amax = vf.abs().amax().reshape((1,) * vf.dim())
    else:
        amax = vf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / _INT8_LEVELS,
                        min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(vf / scale), -_INT8_LEVELS, _INT8_LEVELS)
    return q.to(torch.int8), scale


def dequantize_absmax(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_absmax` (``scale`` broadcasts over the
    axes it kept)."""
    return (q.float() * scale).to(dtype)


__all__ = ["BucketLayout", "GradCommConfig", "WIRE_DTYPES", "allreduce_mean",
           "allreduce_sum", "build_buckets", "dequantize_absmax",
           "make_layouts", "pack_bucket", "quantize_absmax", "resolve_config",
           "unpack_bucket"]
