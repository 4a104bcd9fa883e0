"""Resharding: planned re-layout of split tensors (counterpart of
``paddle_tpu/distributed/reshard.py``).

Every redistribution decomposes into three per-axis moves ("Memory-efficient
array redistribution through portable collective communication",
arXiv:2112.01075):

- **slice**: a mesh axis starts splitting a dim (each rank keeps its part:
  its footprint shrinks);
- **all-to-all**: an axis moves from splitting one dim to another (flat);
- **all-gather**: an axis stops splitting a dim (its footprint grows).

The planner is the reference's, pure Python, step for step: it orders the
moves slice -> all-to-all -> all-gather, so the footprint first shrinks,
stays flat and grows only at the end (a peak of about ``local_src +
local_dst`` bytes a rank, where gathering everything would hold a full
copy), and ends with an ``align`` where the axes of one dim come out in
another order. A layout is the reference's normalised spec: one tuple of
mesh axis names per dim, major to minor (``()`` replicated); a
PartitionSpec-like tuple (``("dp", None)``, ``(("dp", "mp"),)``) is taken
where one is given. ``MeshSpec`` / ``LeafLayout`` are the serialisable
records a checkpoint's manifest keeps (``record_layouts`` /
``read_layout_record``), and ``plan_restore_spec`` the memory-bounded read
spec of a restore onto another layout.

The executor runs a plan on this rank's local block with the port's
collectives, over the groups of a :class:`~.mesh.ProcessMesh`: a slice is a
narrow and a copy; an all-to-all of an axis that is the minor-most of its
dim one ``all_to_all_single`` over that axis's group; an all-gather of the
minor-most axis one ``all_gather_into_tensor`` (of a CUDA block on a gloo
group through pinned host buffers, counted in
``counts["reshard_staged_bytes"]``: gloo's own holds a second device copy
of the output). A move of an axis that is
not the minor-most of its dim, and an ``align``, gather the axes past the
common prefix of each dim from the minor end, then slice the target's
(correct for any layout; the plan's footprint holds for the first kind
only). None of these needs point to
point, which gloo refuses on CUDA tensors. Each step adds its planned
output bytes to ``collective.counts["reshard_moved_bytes"]`` and one to
``["reshard_steps"]`` (the port's counters in place of the reference's
``observability`` events). A move between two meshes (``plan_cross_mesh``)
runs when both hold the same ranks: the source's axes gathered, the
destination's sliced.

``reshard_state`` is two-phase, as the reference's: every new tensor
exists before the caller rebinds anything, so a fault in the middle leaves
the source state whole. Every collective runs inside ``deadline_guard``:
a stall past ``PADDLE_TPU_RESHARD_TIMEOUT`` seconds (default 300) prints a
diagnosis, counts ``reshard_stalls`` and raises ``TimeoutError`` (with
``PADDLE_TPU_RESHARD_KILL_ON_STALL=1``, SIGABRTs the process first). A
chaos fence (``testing/chaos.py::reshard_fence``) stands before each leaf
of ``reshard_state`` and before each planned step, as in the reference, so
a soak can kill a rank mid-reshard. ``record_fallback`` counts a reshard
that degraded to a slower path (``fleet.elastic``'s disk restore).

The module is also callable as ``reshard(tensor, mesh, placements)``, the
placement API of ``auto_parallel``, as the reference's is.
"""
from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import types
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: manifest-meta key the layout record is stored under
LAYOUT_KEY = "reshard"
#: layout record format version (bump on incompatible changes)
LAYOUT_FORMAT = 1

_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "float16": 2,
             "bfloat16": 2, "int32": 4, "float32": 4, "int64": 8,
             "float64": 8, "complex64": 8}


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32``, ``"float32"``, ``np.float32``."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    return s if s in _ITEMSIZE else str(np.dtype(dtype))


def _itemsize(dtype) -> int:
    return _ITEMSIZE[dtype_name(dtype)]


# ---------------------------------------------------------------------------
# serializable layout records
# ---------------------------------------------------------------------------
def _norm_spec(spec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """A spec -> per-dimension tuples of axis names, padded to ndim.
    (Normalized form: every entry is a tuple, replicated dims are ().)"""
    entries = list(spec) if spec is not None else []
    entries += [None] * (ndim - len(entries))
    out = []
    for e in entries[:ndim]:
        if e is None:
            out.append(())
        elif isinstance(e, (tuple, list)):
            out.append(tuple(str(a) for a in e))
        else:
            out.append((str(e),))
    return tuple(out)


def _to_pspec(norm: Sequence[Sequence[str]]) -> Tuple:
    """The normalized form -> a PartitionSpec-like tuple (a name, a tuple of
    names or None per dim, trailing Nones dropped)."""
    entries = []
    for e in norm:
        if not e:
            entries.append(None)
        elif len(e) == 1:
            entries.append(e[0])
        else:
            entries.append(tuple(e))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@dataclass(frozen=True)
class MeshSpec:
    """Serializable mesh shape: ordered (axis name, size) pairs."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        return cls(tuple(mesh.dim_names), tuple(int(s) for s in mesh.shape))

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def device_count(self) -> int:
        return int(np.prod(self.sizes)) if self.sizes else 1

    def to_doc(self) -> dict:
        return {"names": list(self.names), "sizes": list(self.sizes)}

    @classmethod
    def from_doc(cls, doc: dict) -> "MeshSpec":
        return cls(tuple(doc["names"]), tuple(int(s) for s in doc["sizes"]))


@dataclass(frozen=True)
class LeafLayout:
    """Serializable per-leaf layout: global shape, dtype, normalized spec."""

    shape: Tuple[int, ...]
    dtype: str
    spec: Tuple[Tuple[str, ...], ...]

    def pspec(self) -> Tuple:
        return _to_pspec(self.spec)

    def dim_factor(self, dim: int, axis_sizes: Dict[str, int]) -> int:
        f = 1
        for a in self.spec[dim]:
            f *= int(axis_sizes.get(a, 1))
        return f

    def local_bytes(self, axis_sizes: Dict[str, int]) -> int:
        total = int(np.prod(self.shape)) if self.shape else 1
        nbytes = total * _itemsize(self.dtype)
        for d in range(len(self.shape)):
            nbytes //= max(1, self.dim_factor(d, axis_sizes))
        return nbytes

    def to_doc(self) -> dict:
        return {"shape": list(self.shape), "dtype": self.dtype,
                "spec": [list(e) for e in self.spec]}

    @classmethod
    def from_doc(cls, doc: dict) -> "LeafLayout":
        return cls(tuple(int(d) for d in doc["shape"]), str(doc["dtype"]),
                   tuple(tuple(str(a) for a in e) for e in doc["spec"]))


def record_layouts(layouts: Dict[str, LeafLayout],
                   mesh=None) -> Optional[dict]:
    """Layout record for a checkpoint's manifest meta: the source mesh
    (a ``ProcessMesh`` or ``MeshSpec``) and one ``LeafLayout`` a leaf.
    None when there are no leaves and no mesh (a plain checkpoint)."""
    if mesh is None and not layouts:
        return None
    doc = {"format": LAYOUT_FORMAT,
           "leaves": {k: v.to_doc() for k, v in layouts.items()}}
    if mesh is not None:
        ms = mesh if isinstance(mesh, MeshSpec) else MeshSpec.from_mesh(mesh)
        doc["mesh"] = ms.to_doc()
    return doc


def read_layout_record(path: str):
    """(MeshSpec | None, {leaf key: LeafLayout}) from a checkpoint dir's
    commit manifest, or None for a checkpoint without a record."""
    from .checkpoint import manifest as _manifest

    doc = _manifest.read_manifest(path)
    if not doc:
        return None
    rec = (doc.get("meta") or {}).get(LAYOUT_KEY)
    if not isinstance(rec, dict):
        return None
    mesh_doc = rec.get("mesh")
    mesh_spec = MeshSpec.from_doc(mesh_doc) if mesh_doc else None
    leaves = {k: LeafLayout.from_doc(v)
              for k, v in (rec.get("leaves") or {}).items()}
    return mesh_spec, leaves


# ---------------------------------------------------------------------------
# planning (the reference's, step for step)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlanStep:
    """One portable move: the spec AFTER the step plus its footprint."""

    kind: str                       # slice | all_to_all | all_gather | align
    axis: str                       # mesh axis being moved ("" for align)
    spec: Tuple[Tuple[str, ...], ...]  # layout after this step
    in_bytes: int                   # per-rank input footprint
    out_bytes: int                  # per-rank output footprint


@dataclass
class LeafPlan:
    key: str
    shape: Tuple[int, ...]
    dtype: str
    steps: List[PlanStep] = field(default_factory=list)
    transfer: bool = False          # crosses to a different mesh
    peak_bytes: int = 0             # max over steps of in+out per rank
    moved_bytes: int = 0            # sum of per-rank output bytes


def _axis_dim(spec: Tuple[Tuple[str, ...], ...], axis: str) -> Optional[int]:
    for d, e in enumerate(spec):
        if axis in e:
            return d
    return None


def _local_bytes(shape, dtype, spec, axis_sizes) -> int:
    return LeafLayout(tuple(shape), dtype_name(dtype), tuple(spec)
                      ).local_bytes(axis_sizes)


def plan_same_mesh(shape, dtype, src_spec, dst_spec,
                   axis_sizes: Dict[str, int], key: str = "?") -> LeafPlan:
    """Decompose src_spec -> dst_spec on ONE mesh into per-axis portable
    moves, ordered slice -> all-to-all -> all-gather so per-rank memory
    shrinks before it grows (the arXiv:2112.01075 ordering)."""
    ndim = len(shape)
    src = _norm_spec(src_spec, ndim)
    dst = _norm_spec(dst_spec, ndim)
    plan = LeafPlan(key=key, shape=tuple(int(d) for d in shape),
                    dtype=dtype_name(dtype))
    if src == dst:
        plan.peak_bytes = _local_bytes(shape, dtype, src, axis_sizes)
        return plan

    src_of = {a: d for d, e in enumerate(src) for a in e}
    dst_of = {a: d for d, e in enumerate(dst) for a in e}
    slices = sorted([a for a in dst_of if a not in src_of],
                    key=lambda a: -axis_sizes.get(a, 1))   # biggest shrink 1st
    moves = sorted([a for a in src_of if a in dst_of
                    and src_of[a] != dst_of[a]])
    gathers = sorted([a for a in src_of if a not in dst_of],
                     key=lambda a: axis_sizes.get(a, 1))  # biggest growth last

    cur = [list(e) for e in src]
    steps: List[PlanStep] = []

    def emit(kind, axis):
        spec_t = tuple(tuple(e) for e in cur)
        in_b = steps[-1].out_bytes if steps else _local_bytes(
            shape, dtype, src, axis_sizes)
        out_b = _local_bytes(shape, dtype, spec_t, axis_sizes)
        steps.append(PlanStep(kind, axis, spec_t, in_b, out_b))

    for a in slices:
        cur[dst_of[a]].append(a)
        emit("slice", a)
    for a in moves:
        cur[src_of[a]].remove(a)
        cur[dst_of[a]].append(a)
        emit("all_to_all", a)
    for a in gathers:
        cur[src_of[a]].remove(a)
        emit("all_gather", a)
    # final exact constraint: fixes intra-dimension axis ORDER (a tuple spec
    # like ('dp','mp') is dp-major; the greedy appends above may land the
    # axes out of order) at flat per-rank cost
    if tuple(tuple(e) for e in cur) != dst or not steps:
        cur = [list(e) for e in dst]
        emit("align", "")

    plan.steps = steps
    plan.peak_bytes = max(s.in_bytes + s.out_bytes for s in steps)
    plan.moved_bytes = sum(s.out_bytes for s in steps)
    return plan


def plan_cross_mesh(shape, dtype, src_spec, src_axis_sizes,
                    dst_spec, dst_axis_sizes, key: str = "?") -> LeafPlan:
    """Plan across two DIFFERENT meshes: per-shard transfer from the source
    placement onto the destination placement."""
    ndim = len(shape)
    src = _norm_spec(src_spec, ndim)
    dst = _norm_spec(dst_spec, ndim)
    in_b = _local_bytes(shape, dtype, src, src_axis_sizes)
    out_b = _local_bytes(shape, dtype, dst, dst_axis_sizes)
    plan = LeafPlan(key=key, shape=tuple(int(d) for d in shape),
                    dtype=dtype_name(dtype), transfer=True)
    plan.steps = [PlanStep("transfer", "", dst, in_b, out_b)]
    plan.peak_bytes = in_b + out_b
    plan.moved_bytes = out_b
    return plan


def plan_boundary(shape, dtype, src_dp: int, dst_dp: int, *,
                  wire_itemsize: Optional[int] = None,
                  key: str = "?") -> LeafPlan:
    """MPMD stage-boundary respec: one activation micro-batch crossing from
    a stage of width ``src_dp`` onto one of width ``dst_dp`` (batch dim 0
    data-split on both), priced at the wire dtype's ``wire_itemsize``."""
    ndim = len(shape)
    spec_src = _norm_spec(("dp",), ndim)
    spec_dst = _norm_spec(("dp",), ndim)
    in_b = _local_bytes(shape, dtype, spec_src, {"dp": max(int(src_dp), 1)})
    out_b = _local_bytes(shape, dtype, spec_dst, {"dp": max(int(dst_dp), 1)})
    it = int(wire_itemsize) if wire_itemsize else _itemsize(dtype)
    wire_b = int(np.prod([int(d) for d in shape])) * it
    plan = LeafPlan(key=key, shape=tuple(int(d) for d in shape),
                    dtype=dtype_name(dtype), transfer=True)
    plan.steps = [PlanStep("transfer", "dp", spec_dst, in_b, out_b)]
    plan.peak_bytes = max(in_b, out_b) + wire_b
    plan.moved_bytes = wire_b
    return plan


def naive_gather_bytes(shape, dtype) -> int:
    """The bound the planner beats: unshard-everything puts one full copy
    of the leaf on every rank."""
    total = int(np.prod(shape)) if len(shape) else 1
    return total * _itemsize(dtype)


def _sizes(mesh) -> Dict[str, int]:
    """Axis sizes of a ``ProcessMesh``, a ``MeshSpec`` or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.axis_sizes)


def plan_restore_spec(rec: LeafLayout, rec_mesh: Optional[MeshSpec],
                      dst_mesh, dst_spec) -> Tuple:
    """Memory/IO-bounded READ spec for restoring one leaf onto ``dst_mesh``:
    the SOURCE shard granularity re-expressed with the target mesh's axes,
    so every rank reads about its source-local bytes, then the planned
    steps carry it to ``dst_spec``. Falls back to reading at ``dst_spec``
    whenever the source granularity cannot be expressed (or would read
    more than the direct restore)."""
    if rec_mesh is None:
        return dst_spec
    ndim = len(rec.shape)
    src_sizes = rec_mesh.axis_sizes
    dst_sizes = _sizes(dst_mesh)
    want = [rec.dim_factor(d, src_sizes) for d in range(ndim)]
    if all(f == 1 for f in want):
        return dst_spec
    free = dict(dst_sizes)
    out: List[Tuple[str, ...]] = []
    for d in range(ndim):
        f = want[d]
        if f == 1 or rec.shape[d] % f != 0:
            out.append(())
            continue
        pick = next((a for a, s in free.items() if s == f), None)
        if pick is None:
            return dst_spec  # inexpressible on this mesh: direct read
        del free[pick]
        out.append((pick,))
    read = _to_pspec(out)
    read_b = _local_bytes(rec.shape, rec.dtype, _norm_spec(read, ndim),
                          dst_sizes)
    dst_b = _local_bytes(rec.shape, rec.dtype, _norm_spec(dst_spec, ndim),
                         dst_sizes)
    return read if read_b <= dst_b else dst_spec


# ---------------------------------------------------------------------------
# deadline guard
# ---------------------------------------------------------------------------
def _deadline_seconds() -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_RESHARD_TIMEOUT", "300"))
    except ValueError:
        return 300.0


@contextlib.contextmanager
def deadline_guard(what: str, seconds: Optional[float] = None):
    """Bound a collective: a watchdog timer fires if the wrapped op stalls
    past the deadline, counts ``reshard_stalls``, prints a diagnosis naming
    the op and, under ``PADDLE_TPU_RESHARD_KILL_ON_STALL=1``, SIGABRTs so a
    supervisor relaunches from the newest verified checkpoint instead of
    hanging on a dead peer; the op that returns late raises
    ``TimeoutError``."""
    from . import collective

    limit = _deadline_seconds() if seconds is None else float(seconds)
    fired = threading.Event()

    def _stall():
        fired.set()
        collective.counts["reshard_stalls"] += 1
        print(f"[reshard] {what!r} exceeded its {limit:.0f}s deadline: "
              "peer dead or collective wedged; restore from the newest "
              "verified checkpoint if this rank is relaunched",
              file=sys.stderr, flush=True)
        if os.environ.get("PADDLE_TPU_RESHARD_KILL_ON_STALL", "0") == "1":
            os.kill(os.getpid(), signal.SIGABRT)

    timer = threading.Timer(limit, _stall)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
    if fired.is_set():
        raise TimeoutError(
            f"reshard op {what!r} exceeded its {limit:.0f}s deadline")


# ---------------------------------------------------------------------------
# execution on the local block
# ---------------------------------------------------------------------------
def _slice(x, dim, axis, mesh):
    """Keep this rank's part of ``dim`` along ``axis`` (appended minor)."""
    n = mesh.get_dim_size(axis)
    if n == 1:
        return x
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_coord(axis) * k, k).contiguous()


def _gather(x, dim, axis, mesh, what):
    """Undo the minor-most split of ``dim`` by ``axis``: the group's blocks
    concatenated in coordinate order. A CUDA block on a gloo group goes
    through pinned host buffers (gloo's own gather of CUDA tensors holds a
    second device copy of the output), laid out as the result so one copy
    fills it."""
    import torch

    from . import collective
    from .fleet.layers.mpu import _gather_dim

    group = mesh.get_group(axis)
    n = group.nranks
    if n == 1:
        return x
    with deadline_guard(f"all_gather[{axis}] {what}"):
        if not collective._host_staged(x, group.process_group):
            return _gather_dim(x.contiguous(), dim, group)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        parts = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                            dtype=x.dtype, pin_memory=True)
        collective.all_gather(parts, host, group=group)
        shape = list(x.shape)
        shape[dim] *= n
        laid = parts.view((n,) + tuple(x.shape)).movedim(0, dim)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        out.copy_(laid.contiguous().view(shape))
        collective.counts["reshard_staged_bytes"] += parts.numel() * \
            parts.element_size()
        return out


def _all_to_all(x, src_dim, dst_dim, axis, mesh, what):
    """``axis`` (minor-most on ``src_dim``) moves to split ``dst_dim``
    (minor-most there): chunk j of ``dst_dim`` goes to coordinate j, and
    the blocks received are concatenated along ``src_dim`` (a view when
    that is dim 0: the footprint is the send buffer and the receive
    buffer)."""
    import torch

    from . import collective

    group = mesh.get_group(axis)
    n = group.nranks
    if n == 1:
        return x
    inp = torch.stack(torch.chunk(x, n, dim=dst_dim))
    out = torch.empty_like(inp)
    with deadline_guard(f"all_to_all[{axis}] {what}"):
        collective.alltoall_single(out, inp, group=group)
    del inp
    shape = list(out.shape[1:])
    shape[src_dim] *= n
    return out.movedim(0, src_dim).reshape(shape)


def _regather(x, cur, nxt, mesh, what):
    """``cur`` -> ``nxt``: in every dim the axes past the common prefix
    gathered from the minor end, then (all gathers done first: a gather
    over an axis needs its ranks' blocks to agree on every other dim) the
    target's sliced in order."""
    keep = []
    for d, (a, b) in enumerate(zip(cur, nxt)):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        keep.append(k)
        for axis in reversed(a[k:]):
            x = _gather(x, d, axis, mesh, what)
    for d, (b, k) in enumerate(zip(nxt, keep)):
        for axis in b[k:]:
            x = _slice(x, d, axis, mesh)
    return x


def _step(x, cur, step, mesh, what):
    nxt = step.spec
    if step.kind == "slice":
        return _slice(x, _axis_dim(nxt, step.axis), step.axis, mesh)
    if step.kind in ("all_gather", "all_to_all"):
        d = _axis_dim(cur, step.axis)
        if cur[d][-1] == step.axis:
            if step.kind == "all_gather":
                return _gather(x, d, step.axis, mesh, what)
            dd = _axis_dim(nxt, step.axis)
            if nxt[dd][-1] == step.axis:
                return _all_to_all(x, d, dd, step.axis, mesh, what)
    return _regather(x, cur, nxt, mesh, what)


def apply_steps(x, plan: LeafPlan, mesh, src_spec, *, fence_base: int = 0):
    """Walk one leaf's planned steps on ``mesh`` from ``src_spec``, on this
    rank's local block ``x``; returns the new local block."""
    from ..testing import chaos
    from . import collective

    cur = _norm_spec(src_spec, len(plan.shape))
    for i, step in enumerate(plan.steps):
        if step.kind == "transfer":
            continue  # a cross-mesh hop: the caller's
        chaos.reshard_fence(fence_base + i, f"{plan.key}:{step.kind}")
        x = _step(x, cur, step, mesh, f"{step.kind}[{step.axis}] "
                                      f"{plan.key}")
        collective.counts["reshard_moved_bytes"] += step.out_bytes
        collective.counts["reshard_steps"] += 1
        cur = step.spec
    return x


def local_block(full, mesh, spec):
    """This rank's block of the global tensor ``full`` under ``spec``."""
    for d, axes in enumerate(_norm_spec(spec, full.dim())):
        for axis in axes:
            full = _slice(full, d, axis, mesh)
    return full


def local_region(shape, mesh, spec, rank=None):
    """``[(start, stop)]`` per dim of ``rank``'s block under ``spec``."""
    coord = mesh.coordinate(rank)
    out = []
    for d, axes in enumerate(_norm_spec(spec, len(shape))):
        lo, size = 0, int(shape[d])
        for axis in axes:
            n = mesh.get_dim_size(axis)
            size //= n
            lo += coord[mesh.dim_names.index(axis)] * size
        out.append((lo, lo + size))
    return out


def _transfer(x, src_mesh, src_spec, dst_mesh, dst_spec, key):
    """A move between two meshes over the same ranks: the source's axes
    gathered, then the destination's sliced."""
    if sorted(src_mesh.process_ids) != sorted(dst_mesh.process_ids):
        raise NotImplementedError(
            "reshard between meshes over different ranks (a fleet resize) "
            "is not ported, see ROADMAP.md §A.7 item 4")
    ndim = x.dim()
    full = _regather(x, _norm_spec(src_spec, ndim), ((),) * ndim, src_mesh,
                     f"transfer {key}")
    return local_block(full, dst_mesh, dst_spec)


def _layout_of(x):
    """``(mesh, spec)`` of a DTensor placed by the port (or None)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    from .auto_parallel import placements_to_spec

    mesh = getattr(x, "process_mesh", None)
    if mesh is None:
        raise ValueError("a DTensor not placed by paddle.distributed "
                         "(shard_tensor / reshard) has no ProcessMesh")
    return mesh, placements_to_spec(mesh, x.placements, x.dim())


def reshard_array(x, mesh, spec, *, key: str = "?", src_mesh=None,
                  src_spec=None, fence_base: int = 0):
    """Re-lay-out ONE tensor onto ``spec`` on ``mesh`` by the planned
    decomposition: ``x`` a DTensor placed by the port, or this rank's
    local block under ``src_spec`` on ``src_mesh`` (default ``mesh``).
    Returns ``(new, LeafPlan)``: a DTensor for a DTensor, else the new
    local block."""
    layout = _layout_of(x)
    local = x.to_local() if layout is not None else x
    if layout is not None:
        src_mesh, src_spec = layout
    src_mesh = src_mesh or mesh
    shape = tuple(x.shape) if layout is not None else _global_shape(
        local, src_mesh, src_spec)
    dst_sizes = _sizes(mesh)
    if src_mesh == mesh and list(src_mesh.dim_names) == list(mesh.dim_names):
        plan = plan_same_mesh(shape, local.dtype, src_spec, spec, dst_sizes,
                              key=key)
        out = apply_steps(local, plan, mesh, src_spec,
                          fence_base=fence_base)
    else:
        plan = plan_cross_mesh(shape, local.dtype, src_spec,
                               _sizes(src_mesh), spec, dst_sizes, key=key)
        out = _transfer(local, src_mesh, src_spec, mesh, spec, key)
        from . import collective

        collective.counts["reshard_moved_bytes"] += plan.moved_bytes
        collective.counts["reshard_steps"] += 1
    if layout is not None:
        from .auto_parallel import _place

        out = _place(out, mesh, spec, shape)
    return out, plan


def _global_shape(local, mesh, spec):
    return tuple(int(n) * int(np.prod([mesh.get_dim_size(a) for a in e]))
                 for n, e in zip(local.shape, _norm_spec(spec, local.dim())))


def reshard_state(src_state: Dict[str, Any], dst_state: Dict[str, Any],
                  *, what: str = "live") -> Dict[str, Any]:
    """Re-lay-out a flat state dict of placed DTensors onto the layouts of
    ``dst_state``'s DTensors (collectives only, no disk). Two-phase: every
    output exists before the caller rebinds anything. Returns {key: new}
    for every key of ``dst_state``; a key the source lacks raises
    ``KeyError``, a shape that differs ``ValueError``."""
    missing = [k for k in dst_state if k not in src_state]
    if missing:
        raise KeyError(
            f"live reshard source is missing {len(missing)} leaves "
            f"(cannot host the state): {sorted(missing)[:5]}"
            f"{' ...' if len(missing) > 5 else ''}")
    from ..testing import chaos

    out: Dict[str, Any] = {}
    plans: List[LeafPlan] = []
    fence = 0
    for key, tgt in dst_state.items():
        src_v = src_state[key]
        layout = _layout_of(tgt)
        if layout is None or not hasattr(src_v, "shape"):
            out[key] = src_v  # a host leaf (a counter, a scalar)
            continue
        if tuple(src_v.shape) != tuple(tgt.shape):
            raise ValueError(
                f"live reshard leaf {key!r}: source shape "
                f"{tuple(src_v.shape)} != target {tuple(tgt.shape)}")
        chaos.reshard_fence(fence, f"{key}:begin")
        new, plan = reshard_array(src_v, layout[0], layout[1], key=key,
                                  fence_base=fence)
        fence += max(1, len(plan.steps))
        plans.append(plan)
        out[key] = new
    record_plan_metrics(plans, what=what)
    return out


def record_plan_metrics(plans: Sequence[LeafPlan], *, what: str,
                        seconds: float = 0.0) -> None:
    """One record a reshard: the counts of reshards and the largest planned
    peak (``collective.counts``)."""
    from . import collective

    if not plans:
        return
    collective.counts[f"reshard_{what}"] += 1
    peak = max(p.peak_bytes for p in plans)
    collective.counts["reshard_peak_bytes"] = max(
        collective.counts["reshard_peak_bytes"], peak)


def record_fallback(why: str, **fields) -> None:
    """A reshard degraded to a slower, safer path (``fleet.elastic``'s
    disk restore after a failed live resize): counted in
    ``reshard_fallback_total`` and ``collective.counts``, with an event."""
    from .. import observability as _obs
    from . import collective

    collective.counts[f"reshard_fallback_{why}"] += 1
    _obs.inc("reshard_fallback_total", why=why)
    _obs.event("reshard", what="fallback", why=why, **fields)


class _ReshardModule(types.ModuleType):
    """``paddle.distributed.reshard`` is both this module and the placement
    API ``reshard(tensor, mesh, placements)``."""

    def __call__(self, tensor, mesh, placements):
        from .auto_parallel import reshard as _placement_reshard

        return _placement_reshard(tensor, mesh, placements)


sys.modules[__name__].__class__ = _ReshardModule
