"""Gradient communication: bucketing, the f32 exchange and the quantized
wire (counterpart of ``paddle_tpu/distributed/grad_comm.py``).

Gradients cross the data-parallel group in flat buffers ("buckets") of
about ``bucket_mb`` MiB each: :func:`build_buckets` groups the tensors in
their given order (reference :232), :func:`make_layouts` records each
bucket's offsets, :func:`pack_bucket` / :func:`unpack_bucket` concatenate
and split (reference :253-310); :func:`make_shard_layout` /
:func:`pack_shard_major` / :func:`unpack_shard_block` /
:func:`unpack_gathered` are the shard-major layout of a bucket whose
leaves are cut over the sharding ranks (reference :372-460).
:func:`allreduce_mean` all-reduces each bucket over a group and divides it
by the group's size; :func:`allreduce_sum` leaves the sum (a pipeline's
replicated parameters, over the pipe group). The bucket size is
``DistributedStrategy.fuse_grad_size_in_MB`` (32 by default), or
``grad_comm_configs["bucket_mb"]``, overridden by the environment
variable ``PADDLE_TPU_GRAD_COMM`` (see :func:`resolve_config`; the same
grammar, :func:`parse_wire_env`, reads ``PADDLE_TPU_MP_COMM``).

The quantized wire (``wire_dtype`` ``"bf16"`` / ``"int8"``, optionally
with ``error_feedback``): :class:`WireExchange` plans the buckets as the
reference's ``plan_dp_exchange`` does (the trainable parameters whose
ZeRO state dim the sharding degree divides in shard-major buckets first,
the rest after) and each rank quantizes each of its buckets once, as the
reference's ``quantize_roundtrip`` / ``quantize_with_feedback`` do: one
absmax scale a bucket for int8, a bf16 cast, the error-feedback residual
(one f32 buffer a bucket and rank) added first and the quantization
error carried to the next step. The payload crosses in the wire dtype: an
all-to-all of each rank's blocks (int8 beside an all-gather of the f32
scales, or bf16), each rank dequantizes the blocks it received and sums
them in f32 in rank order, divides by the group's size, and an all-gather
returns the f32 result to every rank. ``collective.counts`` adds up
``grad_wire_bytes`` (each rank's quantized payload and scales, the
reference's ``bytes_wire``) and ``grad_wire_f32_bytes`` (the same
payload in f32) per step.

Where the reference's ``DistTrainStep`` falls back from its explicit
exchange to the exact one (``_plan_grad_comm``: model, pipe or sep axes;
ZeRO-3 slices or expert slices; gradient merge; f32 master weights; a
clip with no shard-local form; sharded state without ``zero_update``),
the port's exchange is the exact f32 one too, and a quantized
``wire_dtype`` warns once that it does not apply there.
The serving engine's int8 KV pool uses :func:`quantize_absmax` with the
head_dim axis.
"""
from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch

WIRE_DTYPES = ("f32", "bf16", "int8")

_INT8_LEVELS = 127.0


@dataclass(frozen=True)
class GradCommConfig:
    """Resolved gradient-communication knobs, the reference's fields and
    grammar. The port acts on ``enable``, ``bucket_mb``, ``wire_dtype``,
    ``error_feedback`` and ``zero_update`` (see the module docstring);
    ``overlap`` and ``pipeline_batch_shard`` belong to exchanges the port
    does not have (the exchange runs after the backward; ROADMAP.md
    §A.7), and ZeRO-1/2 here update by whole parameter whatever
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

    @property
    def bucket_bytes(self) -> int:
        return max(int(self.bucket_mb * (1 << 20)), 1)


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


def _bool_key(env_var: str, field: str):
    def apply(cfg, v):
        return replace(cfg, **{field: _parse_bool(env_var, field, v)})
    return apply


def parse_wire_env(env_var: str, cfg, extra_keys=None):
    """The ``off`` / ``on`` / ``f32`` / ``bf16`` / ``int8`` + ``k=v`` grammar
    of a wire's environment variable (the reference's one parser for
    ``PADDLE_TPU_GRAD_COMM`` and ``PADDLE_TPU_MP_COMM``): ``cfg`` a frozen
    dataclass with ``enable`` and ``wire_dtype``, ``extra_keys`` the
    variable's own keys, ``{name: f(cfg, value) -> cfg}``. An unknown
    token or key, or a boolean key's other value, raises."""
    raw = os.environ.get(env_var, "").strip().lower()
    extra_keys = extra_keys or {}
    for part in filter(None, (s.strip() for s in raw.split(","))):
        if "=" not in part:
            if part in _FALSE:
                cfg = replace(cfg, enable=False)
            elif part in _TRUE or part == "f32":
                cfg = replace(cfg, enable=True, wire_dtype="f32")
            elif part in ("bf16", "int8"):
                cfg = replace(cfg, enable=True, wire_dtype=part)
            else:
                raise ValueError(f"{env_var}: bad token {part!r}")
            continue
        k, v = (s.strip() for s in part.split("=", 1))
        if k in ("wire", "wire_dtype"):
            if v not in WIRE_DTYPES:
                raise ValueError(f"{env_var} wire={v!r} not in {WIRE_DTYPES}")
            cfg = replace(cfg, wire_dtype=v, enable=True)
        elif k == "enable":
            cfg = replace(cfg, enable=_parse_bool(env_var, k, v))
        elif k in extra_keys:
            cfg = extra_keys[k](cfg, v)
        else:
            raise ValueError(f"{env_var}: unknown key {k!r}")
    return cfg


def resolve_config(strategy=None) -> GradCommConfig:
    """The strategy's knobs (the fleet strategy's when None), overridden
    by ``PADDLE_TPU_GRAD_COMM`` (:func:`parse_wire_env`, with the keys
    ``bucket_mb``, ``ef`` / ``error_feedback``, ``zero`` /
    ``zero_update``, ``batch_shard`` / ``pipeline_batch_shard`` and
    ``overlap``)."""
    if strategy is None:
        from .fleet import fleet_strategy

        strategy = fleet_strategy()
    var = "PADDLE_TPU_GRAD_COMM"
    return parse_wire_env(var, _strategy_config(strategy), {
        "bucket_mb": lambda c, v: replace(c, bucket_mb=float(v),
                                          enable=True),
        "ef": _bool_key(var, "error_feedback"),
        "error_feedback": _bool_key(var, "error_feedback"),
        "zero": _bool_key(var, "zero_update"),
        "zero_update": _bool_key(var, "zero_update"),
        "batch_shard": _bool_key(var, "pipeline_batch_shard"),
        "pipeline_batch_shard": _bool_key(var, "pipeline_batch_shard"),
        "overlap": _bool_key(var, "overlap"),
    })


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
        for i, lay in enumerate(layouts):
            flat = pack_bucket(same, lay)
            with C.grad_bucket(n + i):
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


def quantize_roundtrip(v, wire_dtype: str):
    """``v`` projected onto what the wire can carry: a bf16 round trip, or
    int8 with one absmax scale over the whole tensor (reference :334)."""
    if wire_dtype == "bf16":
        return v.to(torch.bfloat16).to(v.dtype)
    if wire_dtype == "int8":
        q, scale = quantize_absmax(v)
        return dequantize_absmax(q, scale, v.dtype)
    return v


def quantize_with_feedback(v, residual, wire_dtype: str):
    """Error feedback (reference :347): send ``quant(v + residual)`` and
    carry the quantization error. Returns ``(sent, new_residual)``."""
    c = v + residual.to(v.dtype)
    q = quantize_roundtrip(c, wire_dtype)
    return q, (c - q).to(residual.dtype)


def _encode(v, wire_dtype):
    """``(payload, scale, dequantized)`` of f32 ``v`` on the wire: int8
    with one absmax scale, or bf16 (scale None)."""
    if wire_dtype == "int8":
        q, scale = quantize_absmax(v)
        return q, scale.reshape(1), dequantize_absmax(q, scale)
    q = v.to(torch.bfloat16)
    return q, None, q.float()


# ------------------------------------------------- sharded (ZeRO) layouts --
@dataclass(frozen=True)
class ShardLayout:
    """Shard-major flat layout of a bucket whose leaves are cut into
    ``nshards`` slices along ``dims[i]`` (reference ``ShardLayout``): the
    buffer holds [slice 0 of every leaf, slice 1 of every leaf, ...], so
    rank s's block is contiguous."""

    indices: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dims: Tuple[int, ...]
    nshards: int
    shard_sizes: Tuple[int, ...]
    block: int

    @property
    def total(self) -> int:
        return self.block * self.nshards


def make_shard_layout(indices, shapes, dims, nshards) -> ShardLayout:
    sizes = []
    for shape, d in zip(shapes, dims):
        if shape[d] % nshards:
            raise ValueError(f"shape {tuple(shape)} dim {d} not divisible "
                             f"by {nshards} shards")
        sizes.append(math.prod(shape) // nshards)
    return ShardLayout(tuple(indices), tuple(tuple(s) for s in shapes),
                       tuple(int(d) for d in dims), int(nshards),
                       tuple(sizes), int(sum(sizes)))


def pack_shard_major(leaves, layout: ShardLayout):
    """Full leaves -> one flat shard-major buffer."""
    split = [torch.chunk(leaves[i], layout.nshards, dim=d)
             for i, d in zip(layout.indices, layout.dims)]
    return torch.cat([parts[s].reshape(-1) for s in range(layout.nshards)
                      for parts in split])


def unpack_shard_block(block, layout: ShardLayout):
    """One rank's block -> ``[(index, slice), ...]``, each shaped like the
    leaf with ``dims[i]`` divided by ``nshards``."""
    out, off = [], 0
    for i, shape, d, n in zip(layout.indices, layout.shapes, layout.dims,
                              layout.shard_sizes):
        sshape = list(shape)
        sshape[d] //= layout.nshards
        out.append((i, block[off:off + n].reshape(sshape)))
        off += n
    return out


def unpack_gathered(flat, layout: ShardLayout):
    """A gathered shard-major buffer -> ``[(index, full leaf), ...]``."""
    per = [unpack_shard_block(flat[s * layout.block:(s + 1) * layout.block],
                              layout) for s in range(layout.nshards)]
    return [(i, torch.cat([per[s][j][1] for s in range(layout.nshards)],
                          dim=layout.dims[j]))
            for j, (i, _) in enumerate(per[0])]


# -------------------------------------------------------- the quantized wire --
def _wire_mean(flat, group, wire_dtype, block=None):
    """The group's mean of each rank's f32 ``flat`` through the wire, in
    f32 on every rank; each rank's payload is quantized once and the
    dequantized payloads are summed in f32 in rank order, by the route
    that moves fewer bytes: below ``1 + 4 / itemsize`` ranks (int8: 5,
    bf16: 3) every rank all-gathers the whole payloads, ``(n - 1) N w``
    bytes a rank; from there an all-to-all sends each rank its block
    (of ``block`` elements, the buffer padded to ``group.nranks`` of
    them), which it sums, and an all-gather of the f32 blocks gives the
    whole, ``(n - 1) / n N (w + 4)``. int8 moves the ranks' scales
    beside. Returns ``(mean, dequantized own payload)``."""
    from . import collective as C

    n = group.nranks
    q, scale, deq = _encode(flat, wire_dtype)
    total = flat.numel()
    scales = (C.stacked_all_gather(scale, group) if scale is not None
              else torch.ones((n, 1), device=flat.device))
    if n * q.element_size() < q.element_size() + 4:
        got = C.stacked_all_gather(q, group)
        return C.rank_order_sum(got.float() * scales) / n, deq
    block = block or -(-total // n)
    if block * n != total:
        q = torch.cat([q, q.new_zeros(block * n - total)])
    got = torch.empty_like(q)
    C.alltoall_single(got.view(torch.uint8), q.contiguous().view(torch.uint8),
                      group=group)
    acc = C.rank_order_sum(got.reshape(n, block).float() * scales) / n
    out = torch.empty(n * block, dtype=torch.float32, device=flat.device)
    C.all_gather(out, acc, group=group)
    return out[:total], deq


@dataclass
class WireExchange:
    """The quantized gradient exchange of one parameter list over a data
    group (see the module docstring): the buckets, in the reference's
    plan (shard-major ZeRO buckets, then the rest), and the
    error-feedback residuals, one f32 buffer a bucket."""

    wire_dtype: str
    group: object
    zero_layouts: Tuple[ShardLayout, ...]
    tail_layouts: Tuple[BucketLayout, ...]
    residuals: Optional[List[torch.Tensor]] = None

    @property
    def n_elems(self) -> int:
        return sum(l.total for l in self.zero_layouts + self.tail_layouts)

    @property
    def bytes_f32(self) -> int:
        return 4 * self.n_elems

    @property
    def bytes_wire(self) -> int:
        """The payload a step: the wire dtype's bytes and, for int8, one
        f32 scale a bucket."""
        it = {"bf16": 2, "int8": 1}[self.wire_dtype]
        scales = 4 * (len(self.zero_layouts) + len(self.tail_layouts)) \
            if self.wire_dtype == "int8" else 0
        return it * self.n_elems + scales

    def __call__(self, grads):
        """Replace ``grads`` (by parameter position; None where absent) with
        their mean over the group through the wire, in place."""
        from . import collective as C

        n = self.group.nranks
        layouts = self.zero_layouts + self.tail_layouts
        for b, lay in enumerate(layouts):
            zero = b < len(self.zero_layouts)
            leaves = {i: (grads[i] if grads[i] is not None
                          else torch.zeros(lay.shapes[j], device=self._dev(
                              grads)))
                      for j, i in enumerate(lay.indices)}
            flat = (pack_shard_major(leaves, lay) if zero
                    else pack_bucket(leaves, lay)).float()
            if self.residuals is not None:
                flat = flat + self.residuals[b].to(flat.device)
            # the wire's gathers and local sums implement the bucket's
            # all-reduce (the reference's program emits it as one)
            with C.grad_bucket(b, as_kind="all-reduce"):
                mean, deq = _wire_mean(flat, self.group, self.wire_dtype,
                                       lay.block if zero else None)
            if self.residuals is not None:
                self.residuals[b] = flat - deq
            parts = unpack_gathered(mean, lay) if zero \
                else unpack_bucket(mean, lay)
            for i, v in parts:
                if grads[i] is not None:
                    grads[i].copy_(v)
        C.counts["grad_wire_bytes"] += self.bytes_wire
        C.counts["grad_wire_f32_bytes"] += self.bytes_f32

    @staticmethod
    def _dev(grads):
        return next(g.device for g in grads if g is not None)


def plan_wire(cfg: GradCommConfig, params, group, nshards, state_dims
              ) -> Optional[WireExchange]:
    """The :class:`WireExchange` of ``params`` (the trainable ones, by
    position) over ``group``, as the reference's ``plan_dp_exchange``:
    ``state_dims[i]`` the dim parameter ``i``'s ZeRO state is cut on (None:
    whole). None when the sharded state has no shard-local update
    (``zero_update`` off), where the reference keeps its exact exchange."""
    zero = cfg.zero_update and nshards > 1
    if nshards > 1 and not cfg.zero_update:
        return None
    shardable, tail = [], []
    for i, (p, k) in enumerate(zip(params, state_dims)):
        if zero and k is not None and p.shape[k] % nshards == 0:
            shardable.append(i)
        else:
            tail.append(i)
    zero_layouts = []
    if shardable:
        sizes = [p.numel() * p.element_size()
                 for p in (params[i] for i in shardable)]
        for g in build_buckets(sizes, cfg.bucket_bytes):
            idx = [shardable[j] for j in g]
            zero_layouts.append(make_shard_layout(
                idx, [tuple(params[i].shape) for i in idx],
                [state_dims[i] for i in idx], nshards))
    tail_layouts = []
    if tail:
        tail_layouts = make_layouts(
            [tuple(params[i].shape) for i in tail],
            [params[i].element_size() for i in tail], cfg.bucket_bytes,
            indices=tail)
    ex = WireExchange(cfg.wire_dtype, group, tuple(zero_layouts),
                      tuple(tail_layouts))
    if cfg.error_feedback:
        dev = params[0].device if params else None
        ex.residuals = [torch.zeros(l.total, dtype=torch.float32,
                                    device=dev)
                        for l in ex.zero_layouts + ex.tail_layouts]
    return ex


_warned = set()


def warn_unapplied(cfg: GradCommConfig, why: str):
    """Once a reason: a quantized wire that this exchange does not apply
    (the reference's exact fall-back, see the module docstring)."""
    if cfg.quantized and why not in _warned:
        _warned.add(why)
        warnings.warn(f"grad_comm wire_dtype={cfg.wire_dtype!r} is not "
                      f"applied with {why}: the gradients are exchanged "
                      "in f32, as the reference does", stacklevel=3)


__all__ = ["BucketLayout", "GradCommConfig", "ShardLayout", "WIRE_DTYPES",
           "WireExchange", "allreduce_mean", "allreduce_sum",
           "build_buckets", "dequantize_absmax", "make_layouts",
           "make_shard_layout", "pack_bucket", "pack_shard_major",
           "parse_wire_env", "plan_wire", "quantize_absmax",
           "quantize_roundtrip", "quantize_with_feedback", "resolve_config",
           "unpack_bucket", "unpack_gathered", "unpack_shard_block",
           "warn_unapplied"]
