"""Collective communication (counterpart of
``paddle_tpu/distributed/collective.py`` :238-595), on
``torch.distributed``.

Paddle's signatures and its in-place semantics: ``all_reduce`` /
``broadcast`` / ``reduce`` / ``scatter`` / ``recv`` write into the tensor
given; ``src`` / ``dst`` / ``peer`` are global ranks; every call returns a
task whose ``wait()`` blocks until the collective is done (already done
when ``sync_op`` is True). The reference is one process holding every
device, so its eager collectives act as if every rank held the same value
(``all_reduce`` of ``v`` gives ``n * v``); here each rank contributes its
own tensor, and ``reduce`` defines the result on ``dst`` only, as Paddle
does (the reference's is an all-reduce).

``ReduceOp.AVG`` is a sum divided by the group's size (gloo has no
average). ``counts`` counts the collectives issued, by name, for the
on-card check that a path really communicated; ``reset_counts`` zeroes it.

Point to point on a gloo group stages a CUDA tensor through a pinned host
buffer (gloo's send hands the tensor's pointer to its socket, which
refuses a device address): ``send`` / ``isend`` copy the tensor there
and send that, ``recv`` / ``irecv`` receive there and copy into the
tensor when the task completes, and ``batch_isend_irecv`` does the same
for each op. The choice is made by the group's backend: an NCCL group and
a CPU tensor pass the tensor as it is. ``counts["p2p_staged_bytes"]``
adds up the bytes staged.

The quantized collectives (reference :109-236): :func:`psum_quantized`
sums each rank's value after one pass through a reduced-precision wire
(bf16, or int8 with one absmax scale), the payload all-gathered in the
wire dtype and the sum taken in f32 in rank order; its backward sums the
cotangents round-tripped through the wire. :func:`all_gather_quantized`
gathers a flat f32 vector in the wire dtype (int8 with one scale a
segment); its backward reduce-scatters the round-tripped cotangent.
Both are autograd functions over a group (the reference's take a mesh
axis).

:func:`record_collectives` records, while it is on, every collective
this rank issues (``comm_analysis.py`` reads the records: kind, payload,
wire dtype, the group's ranks and mesh axes, the gradient-exchange
bucket). ``grad_bucket`` marks the collectives of one bucket, and names
the reduction a quantized wire implements by gathers.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from .env import Group, _resolve_group, get_rank

counts: collections.Counter = collections.Counter()


def reset_counts():
    counts.clear()


# ----------------------------------------------------------- the recorder --
#: the records while :func:`record_collectives` is on (None: off)
_records = None
#: (bucket index, kind it implements) in force (:func:`grad_bucket`)
_bucket = (None, None)
#: the payload's dtype while a collective moves it as bytes
_dtype_hint = None

_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
               torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
               torch.int64: "s64", torch.bool: "pred"}


@contextlib.contextmanager
def record_collectives():
    """Within: every collective this rank issues over more than one rank
    is appended to the list this yields (``comm_analysis.py``'s
    records)."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


@contextlib.contextmanager
def grad_bucket(index: int, as_kind: Optional[str] = None):
    """Within: the collectives belong to gradient-exchange bucket
    ``index``; with ``as_kind`` they are recorded as that reduction (the
    quantized wire's gathers and local sum are an all-reduce), their
    payload the rank's share."""
    global _bucket
    prev, _bucket = _bucket, (index, as_kind)
    try:
        yield
    finally:
        _bucket = prev


def _record(kind, g, in_bytes, out_bytes, dtype):
    """One record (see :func:`record_collectives`): the payload counts the
    gathered output of an all-gather, the shard out of a reduce-scatter,
    the rank's input otherwise, as the reference reads HLO."""
    if _records is None or g.nranks <= 1:
        return
    from .comm_analysis import axes_of_ranks, wire_model_bytes
    from .mesh import get_global_mesh

    bucket, as_kind = _bucket
    issued = kind
    kind = as_kind or kind
    payload = {"all-gather": out_bytes,
               "reduce-scatter": out_bytes}.get(kind, in_bytes)
    n = g.nranks
    mesh = get_global_mesh()
    _records.append({
        "kind": kind, "payload_bytes": int(payload), "group_size": n,
        "axes": (axes_of_ranks(g.ranks, mesh) if mesh is not None
                 else ("unknown",)),
        "wire_bytes_per_device": wire_model_bytes(kind, payload, n),
        "wire_dtype": _HLO_DTYPES.get(_dtype_hint or dtype, str(dtype)),
        "bucket": bucket, "issued": issued, "ranks": list(g.ranks)})


def _nbytes(t):
    return t.numel() * t.element_size()


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


class _Task:
    """What a collective returns: ``wait()`` finishes it (and the AVG
    division, when there is one); ``is_completed()`` reports it."""

    def __init__(self, work=None, then=None, keep=None):
        # ``keep``: a buffer the pending op reads or writes, held until done
        self._work, self._then, self._keep = work, then, keep

    def wait(self, timeout=None):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._then is not None:
            self._then()
            self._then = None
        self._keep = None
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _issue(name, fn, group, sync_op, then=None, rec=None):
    """Run ``fn(pg, async_op)`` on ``group``; a process outside the group
    does nothing, as in Paddle. ``rec`` = (kind, input bytes, output
    bytes, dtype) for the recorder."""
    g = _resolve_group(group)
    if not g.is_member():
        return _Task()
    counts[name] += 1
    if rec is not None:
        _record(rec[0], g, *rec[1:])
    work = fn(g.process_group, not sync_op)
    # a synchronous torch call returns None (recv: the sender's rank)
    task = _Task(work if hasattr(work, "wait") else None, then)
    if sync_op:
        task.wait()
    return task


def _avg_then(tensor, op, g: Group):
    """AVG's division after the sum (truncating on integers)."""
    if op != ReduceOp.AVG:
        return None
    mode = None if tensor.is_floating_point() else "trunc"
    return lambda: tensor.div_(g.nranks, rounding_mode=mode)


# ---------------------------------------------------------------- reductions
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True):
    """Reduce ``tensor`` over the group, in place on every rank."""
    g = _resolve_group(group)
    nb = _nbytes(tensor)
    return _issue("all_reduce",
                  lambda pg, a: dist.all_reduce(tensor, _TORCH_OPS[op], pg,
                                                async_op=a),
                  g, sync_op, _avg_then(tensor, op, g),
                  ("all-reduce", nb, nb, tensor.dtype))


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group onto global rank ``dst``, in place
    there; elsewhere the tensor's content is not defined."""
    g = _resolve_group(group)
    then = _avg_then(tensor, op, g) if get_rank() == dst else None
    return _issue("reduce",
                  lambda pg, a: dist.reduce(tensor, dst, _TORCH_OPS[op], pg,
                                            async_op=a),
                  g, sync_op, then)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce over the group and keep this rank's part in ``tensor``.

    ``tensor_list`` a list: part ``i`` is the reduction of every rank's
    ``tensor_list[i]``. A tensor: it is cut into ``nranks`` equal parts
    along dim 0. None (the reference's functional form): ``tensor`` is the
    input, and the new ``[k, ...]`` part is returned instead of a task."""
    g = _resolve_group(group)
    functional = tensor_list is None
    if functional:
        inp = tensor
        tensor = inp.new_empty((inp.shape[0] // g.nranks,) + inp.shape[1:])
    else:
        inp = tensor_list
    if isinstance(inp, (list, tuple)):
        fn = lambda pg, a: dist.reduce_scatter(  # noqa: E731
            tensor, list(inp), _TORCH_OPS[op], pg, async_op=a)
    else:
        fn = lambda pg, a: _reduce_scatter_tensor(  # noqa: E731
            tensor, inp.contiguous(), _TORCH_OPS[op], pg, async_op=a)
    task = _issue("reduce_scatter", fn, g, sync_op,
                  _avg_then(tensor, op, g),
                  ("reduce-scatter", _nbytes(tensor) * g.nranks,
                   _nbytes(tensor), tensor.dtype))
    return tensor if functional else task


# ----------------------------------------------------------------- gathering
def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``, in group order.

    ``tensor_list`` a list: the ``nranks`` tensors are appended to it. A
    tensor: it receives them concatenated along ``axis``. None: the list
    is returned instead of a task."""
    g = _resolve_group(group)
    rec = ("all-gather", _nbytes(tensor), _nbytes(tensor) * g.nranks,
           tensor.dtype)
    if isinstance(tensor_list, torch.Tensor):
        out = tensor_list
        if axis == 0:
            return _issue("all_gather", lambda pg, a: _all_gather_tensor(
                out, tensor.contiguous(), pg, async_op=a), g, sync_op,
                rec=rec)
        parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
        return _issue("all_gather", lambda pg, a: dist.all_gather(
            parts, tensor.contiguous(), pg, async_op=a), g, sync_op,
            lambda: out.copy_(torch.cat(parts, dim=axis)), rec)
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
    task = _issue("all_gather", lambda pg, a: dist.all_gather(
        parts, tensor.contiguous(), pg, async_op=a), g, sync_op, rec=rec)
    if tensor_list is None:
        task.wait()
        return parts
    tensor_list.extend(parts)
    return task


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable ``obj``, appended to ``object_list``."""
    g = _resolve_group(group)
    out = [None] * g.nranks
    counts["all_gather_object"] += 1
    dist.all_gather_object(out, obj, group=g.process_group)
    object_list.extend(out)
    return object_list


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` onto global rank ``dst``, appended to
    ``gather_list`` there (other ranks' lists stay as they are)."""
    g = _resolve_group(group)
    on_dst = get_rank() == dst
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)] \
        if on_dst else None
    task = _issue("gather", lambda pg, a: dist.gather(
        tensor.contiguous(), parts, dst, pg, async_op=a), g, sync_op)
    if on_dst and gather_list is not None:
        task.wait()
        gather_list.extend(parts)
    return task


# ----------------------------------------------------------------- broadcast
def broadcast(tensor, src=0, group=None, sync_op=True):
    """Global rank ``src``'s ``tensor`` written into every rank's."""
    nb = _nbytes(tensor)
    return _issue("broadcast", lambda pg, a: dist.broadcast(
        tensor, src, pg, async_op=a), group, sync_op,
        rec=("broadcast", nb, nb, tensor.dtype))


def broadcast_object_list(object_list, src=0, group=None):
    """Global rank ``src``'s objects written into every rank's list, in
    place."""
    g = _resolve_group(group)
    counts["broadcast_object_list"] += 1
    dist.broadcast_object_list(object_list, src, group=g.process_group)
    return object_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Part ``i`` of ``src``'s ``tensor_list`` written into group rank
    ``i``'s ``tensor``."""
    on_src = get_rank() == src
    lst = [t.contiguous() for t in tensor_list] if on_src else None
    return _issue("scatter", lambda pg, a: dist.scatter(
        tensor, lst, src, pg, async_op=a), group, sync_op)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Object ``i`` of ``src``'s ``in_object_list`` appended to group rank
    ``i``'s ``out_object_list``."""
    g = _resolve_group(group)
    out = [None]
    counts["scatter_object_list"] += 1
    dist.scatter_object_list(out, in_object_list if get_rank() == src
                             else None, src, group=g.process_group)
    out_object_list.append(out[0])
    return out_object_list


# ------------------------------------------------------------------ all-to-all
def alltoall(out_tensor_list, in_tensor_list=None, group=None, sync_op=True):
    """Rank ``i``'s ``in_tensor_list[j]`` goes to rank ``j``'s
    ``out_tensor_list[i]``. An empty ``out_tensor_list`` is filled."""
    g = _resolve_group(group)
    ins = [t.contiguous() for t in in_tensor_list]
    if not out_tensor_list:
        out_tensor_list.extend(torch.empty_like(t) for t in ins)
    nb = sum(_nbytes(t) for t in ins)
    return _issue("alltoall", lambda pg, a: dist.all_to_all(
        out_tensor_list, ins, pg, async_op=a), g, sync_op,
        rec=("all-to-all", nb, nb, ins[0].dtype if ins else None))


def alltoall_single(out_tensor, in_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """All-to-all of one tensor cut along dim 0 (equal parts, or the split
    sizes given), written into ``out_tensor``."""
    nb = _nbytes(in_tensor)
    return _issue("alltoall_single", lambda pg, a: dist.all_to_all_single(
        out_tensor, in_tensor.contiguous(), out_split_sizes, in_split_sizes,
        pg, async_op=a), group, sync_op,
        rec=("all-to-all", nb, nb, in_tensor.dtype))


# --------------------------------------------------------------- point to point
def _host_staged(tensor, pg) -> bool:
    """Whether a point-to-point op on ``tensor`` over the process group
    ``pg`` goes through a pinned host buffer: a CUDA tensor on a gloo
    group (decided by the backend, never by trying)."""
    return tensor.is_cuda and str(dist.get_backend(pg)) == "gloo"


def _p2p_buffer(tensor, pg, sending):
    """``(buffer, then)``: what a point-to-point op on ``tensor`` over
    ``pg`` passes to ``torch.distributed``, and what runs once it
    completes. A host-staged op (:func:`_host_staged`) goes through a
    pinned host buffer, filled now for a send, copied into ``tensor``
    after a receive; anything else passes as it is."""
    if not _host_staged(tensor, pg):
        return (tensor.contiguous() if sending else tensor), None
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    counts["p2p_staged_bytes"] += host.numel() * host.element_size()
    if sending:
        host.copy_(tensor)
        return host, None
    return host, lambda: tensor.copy_(host)


def _p2p(name, tensor, peer, group, sync_op, sending, tag=0):
    g = _resolve_group(group)
    if not g.is_member():
        return _Task()
    counts[name] += 1
    buf, then = _p2p_buffer(tensor, g.process_group, sending)
    if sync_op:
        (dist.send if sending else dist.recv)(buf, peer, g.process_group,
                                              tag)
        work = None
    else:
        work = (dist.isend if sending else dist.irecv)(
            buf, peer, g.process_group, tag)
    task = _Task(work, then, buf)
    if sync_op:
        task.wait()
    return task


def send(tensor, dst=0, group=None, sync_op=True):
    return _p2p("send", tensor, dst, group, sync_op, True)


def recv(tensor, src=0, group=None, sync_op=True):
    return _p2p("recv", tensor, src, group, sync_op, False)


def isend(tensor, dst=0, group=None, sync_op=False):
    """``send`` that returns its task unwaited unless ``sync_op`` (the
    reference's ``isend`` is its ``send``, which takes ``sync_op``)."""
    return send(tensor, dst, group, sync_op=sync_op)


def irecv(tensor, src=0, group=None, sync_op=False):
    """``recv``, likewise."""
    return recv(tensor, src, group, sync_op=sync_op)


class P2POp:
    """paddle.distributed.P2POp: one send or receive of a batch for
    :func:`batch_isend_irecv`; ``peer`` a global rank. ``tag`` (not in
    Paddle's signature) keeps apart two streams between the same pair of
    ranks on gloo; NCCL matches by order only."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        if op not in (send, recv, isend, irecv):
            raise ValueError("P2POp op must be paddle.distributed "
                             "isend / irecv (or send / recv)")
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group
        self.tag = tag


def batch_isend_irecv(p2p_op_list):
    """Issue every op of the batch at once; returns their tasks."""
    ops, thens, bufs = [], [], []
    for p in p2p_op_list:
        g = _resolve_group(p.group)
        sending = p.op in (send, isend)
        if sending:  # a send of the batch is one hop of a permute
            _record("collective-permute", g, _nbytes(p.tensor),
                    _nbytes(p.tensor), p.tensor.dtype)
        buf, then = _p2p_buffer(p.tensor, g.process_group, sending)
        ops.append(dist.P2POp(dist.isend if sending else dist.irecv, buf,
                              p.peer, g.process_group, p.tag))
        thens.append(then)
        bufs.append(buf)
    if not ops:
        return []
    counts["batch_isend_irecv"] += 1
    works = dist.batch_isend_irecv(ops)
    if len(works) != len(ops):
        # NCCL coalesces the batch into one work; nothing was staged
        return [_Task(w, keep=bufs) for w in works]
    return [_Task(w, t, b) for w, t, b in zip(works, thens, bufs)]


# ----------------------------------------------------------------------- misc
def barrier(group=None):
    g = _resolve_group(group)
    if g.is_member():
        counts["barrier"] += 1
        dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the device has finished the work queued so far (the
    collectives on ``tensor`` among it)."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def get_backend(group=None):
    """``"NCCL"`` or ``"GLOO"``, as Paddle names them."""
    return str(dist.get_backend(_resolve_group(group).process_group)).upper()


def _all_gather_tensor(out, inp, pg, async_op):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return fn(out, inp, group=pg, async_op=async_op)


def _reduce_scatter_tensor(out, inp, op, pg, async_op):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(out, inp, op=op, group=pg, async_op=async_op)


# ---------------------------------------------------- quantized collectives
def stacked_all_gather(x, group=None):
    """Every rank's ``x`` stacked on a new dim 0, in group order; moved as
    bytes, so a payload in any dtype (int8, bf16) crosses as it is."""
    global _dtype_hint
    g = _resolve_group(group)
    x = x.contiguous()
    out = torch.empty((g.nranks,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    prev, _dtype_hint = _dtype_hint, x.dtype
    try:
        all_gather(out.view(torch.uint8).reshape(-1),
                   x.view(torch.uint8).reshape(-1), group=g)
    finally:
        _dtype_hint = prev
    return out


def rank_order_sum(parts):
    """``parts[0] + parts[1] + ...`` over dim 0 in f32, in that order (the
    same value on every rank that holds the same parts)."""
    parts = parts.float()
    acc = parts[0].clone()
    for r in range(1, parts.shape[0]):
        acc += parts[r]
    return acc


def _psum_wire(v, g: Group, wire_dtype):
    from .grad_comm import quantize_absmax

    v32 = v.float()
    if wire_dtype == "int8":
        q, scale = quantize_absmax(v32)
        parts = stacked_all_gather(q, g).float() \
            * stacked_all_gather(scale, g)
    elif wire_dtype == "bf16":
        parts = stacked_all_gather(v32.to(torch.bfloat16), g)
    else:
        out = v.clone()
        all_reduce(out, group=g)
        return out
    return rank_order_sum(parts).to(v.dtype)


class _PsumQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g, wire_dtype):
        ctx.g, ctx.wire = g, wire_dtype
        return _psum_wire(v, g, wire_dtype)

    @staticmethod
    def backward(ctx, ct):
        from .grad_comm import quantize_roundtrip

        ctq = quantize_roundtrip(ct.float(), ctx.wire)
        all_reduce(ctq, group=ctx.g)
        return ctq.to(ct.dtype), None, None


def psum_quantized(v, group=None, wire_dtype="bf16", via="gather"):
    """The sum of every rank's ``v`` through a reduced-precision wire: each
    rank's value quantized once (bf16, or int8 with one absmax scale),
    gathered in the wire dtype, dequantized and summed in f32 in rank
    order, returned in ``v``'s dtype. ``via`` is the reference's choice
    between a simulated and a real exchange; here the exchange is always
    the real one, whose numbers both give."""
    return _PsumQuantized.apply(v, _resolve_group(group), wire_dtype)


class _AllGatherQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g, wire_dtype, segs, grad_wire):
        ctx.g, ctx.grad_wire = g, grad_wire
        v32 = v.float()
        if wire_dtype == "bf16":
            return stacked_all_gather(v32.to(torch.bfloat16),
                                      g).float().reshape(-1)
        qs, scales = [], []
        for seg in torch.split(v32, list(segs)):
            s = torch.clamp(seg.abs().amax() / 127.0, min=1e-12)
            qs.append(torch.clamp(torch.round(seg / s), -127.0,
                                  127.0).to(torch.int8))
            scales.append(s)
        q = stacked_all_gather(torch.cat(qs), g).float()    # [n, total]
        sc = stacked_all_gather(torch.stack(scales), g)      # [n, n_segs]
        sexp = torch.repeat_interleave(
            sc, torch.tensor(list(segs), device=sc.device), dim=1)
        return (q * sexp).reshape(-1)

    @staticmethod
    def backward(ctx, ct):
        from .grad_comm import quantize_roundtrip

        ctq = quantize_roundtrip(ct.float(), ctx.grad_wire)
        out = ctq.new_empty(ctq.numel() // ctx.g.nranks)
        reduce_scatter(out, ctq, group=ctx.g)
        return out.to(ct.dtype), None, None, None, None


def all_gather_quantized(v, group=None, *, wire_dtype="int8",
                         segments=None, grad_wire=None):
    """Every rank's flat f32 ``v`` concatenated, through the wire: int8
    with one f32 absmax scale a segment (``segments``, the flat sizes of
    the leaves packed in ``v``; one scale when None), or bf16. The
    backward reduce-scatters the cotangent round-tripped through
    ``grad_wire`` (the forward's wire when None)."""
    g = _resolve_group(group)
    if wire_dtype not in ("bf16", "int8"):
        out = v.new_empty(g.nranks * v.numel())
        all_gather(out, v.contiguous(), group=g)
        return out
    segs = (int(v.shape[0]),) if segments is None else \
        tuple(int(n) for n in segments)
    if sum(segs) != int(v.shape[0]):
        raise ValueError(f"all_gather_quantized: segments sum {sum(segs)} "
                         f"!= payload length {int(v.shape[0])}")
    return _AllGatherQuantized.apply(v, g, wire_dtype, segs,
                                     grad_wire or wire_dtype)


class stream:
    """paddle.distributed.stream: the same collectives (a comm stream of
    its own is not modelled)."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    broadcast = staticmethod(broadcast)
    scatter = staticmethod(scatter)
    reduce = staticmethod(reduce)
    send = staticmethod(send)
    recv = staticmethod(recv)


__all__ = ["P2POp", "ReduceOp", "all_gather", "all_gather_object",
           "all_gather_quantized",
           "all_reduce", "alltoall", "alltoall_single", "barrier",
           "batch_isend_irecv", "broadcast", "broadcast_object_list",
           "counts", "gather", "get_backend", "grad_bucket", "irecv",
           "isend", "psum_quantized", "rank_order_sum",
           "record_collectives", "recv",
           "reduce", "reduce_scatter", "reset_counts", "scatter",
           "stacked_all_gather",
           "scatter_object_list", "send", "stream", "wait"]
