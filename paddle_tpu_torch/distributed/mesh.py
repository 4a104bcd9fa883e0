"""The process mesh and the global mesh (counterpart of
``paddle_tpu/distributed/mesh.py``).

The reference names a ``jax.sharding.Mesh`` of devices; here a
:class:`ProcessMesh` is a grid of global ranks with named axes, and each
axis carries the ``torch.distributed`` groups of the ranks that differ from
one another only along it (the groups a collective over that axis runs
on). Creating a group is a collective of the whole world, so a mesh never
makes a second set: a group whose ranks one made before (the ``fleet``
topology's groups, another mesh's) is reused, and every rank builds the
same mesh, so every rank makes the same missing groups in the same order.
``ProcessMesh.device_mesh()`` is the ``torch.distributed`` ``DeviceMesh``
over those groups, which ``DTensor`` places tensors on.

``HYBRID_AXES`` is the hybrid order ``(dp, pp, sharding, sep, mp)``, mp
innermost: the ``fleet`` topology lays the ranks out in it and
``fleet.init`` sets the global mesh over them (degenerate axes kept, as
the reference's ``HybridCommunicateGroup`` does). ``build_mesh`` is the
rank grid in the order given; the reference's ICI / DCN device
arrangement of a TPU torus (``build_hybrid_mesh``) is, on ranks, the grid
in ``HYBRID_AXES`` order, and its multi-slice split raises.

``sharding_constraint`` on a plain tensor is the identity (the reference's
with no mesh: the port's model bodies hold local tensors, whose layout the
mp layers fix); on a ``DTensor`` it is ``reshard`` to the spec's
placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_state = threading.local()

# Canonical hybrid axis names, outermost -> innermost.
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")


def _world_size() -> int:
    from .env import get_world_size

    return get_world_size()


def _axis_groups(ids: np.ndarray, axis: int) -> List[List[int]]:
    """Every group of ranks along ``axis`` of the grid ``ids``: the ranks
    that differ only on it, in grid order."""
    moved = np.moveaxis(ids, axis, -1).reshape(-1, ids.shape[axis])
    return [[int(r) for r in row] for row in moved]


def _group_of(ranks: Sequence[int]):
    """The port's group over ``ranks``: one made before (the fleet
    topology's, another mesh's), else a new one (a collective of the
    world: every rank calls this in the same order)."""
    from . import env

    ranks = [int(r) for r in ranks]
    for g in env._groups:
        if g.ranks == ranks:
            return g
    return env.new_group(ranks)


class ProcessMesh:
    """paddle.distributed.ProcessMesh: a grid of global ranks with named
    axes (``mesh``, or ``process_ids`` reshaped to ``shape``; default the
    whole world as one axis)."""

    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None,
                 process_ids: Optional[Sequence[int]] = None):
        if mesh is not None:
            arr = np.asarray(mesh)
        else:
            ids = process_ids if process_ids is not None \
                else range(_world_size())
            arr = np.asarray(list(ids)).reshape(
                tuple(shape) if shape else (-1,))
        self._ids = arr.astype(np.int64)
        self.shape = list(arr.shape)
        self.ndim = arr.ndim
        self.dim_names = (list(dim_names) if dim_names
                          else [f"d{i}" for i in range(arr.ndim)])
        if len(self.dim_names) != self.ndim:
            raise ValueError(f"dim_names {self.dim_names} do not name the "
                             f"{self.ndim} axes of a mesh of shape "
                             f"{self.shape}")
        self.process_ids = [int(i) for i in arr.ravel()]
        self._groups = None
        self._device_mesh = None

    # -- layout ------------------------------------------------------------
    @property
    def mesh(self) -> np.ndarray:
        return self._ids

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.dim_names, self.shape))

    def get_dim_size(self, name: str) -> int:
        return self.shape[self.dim_names.index(name)]

    def coordinate(self, rank: Optional[int] = None) -> Optional[Tuple]:
        """``rank``'s (default this process's) coordinate on the grid, or
        None when the mesh does not hold it."""
        if rank is None:
            from .env import get_rank

            rank = get_rank()
        hit = np.argwhere(self._ids == rank)
        return tuple(int(c) for c in hit[0]) if len(hit) else None

    def axis_coord(self, name: str, rank: Optional[int] = None) -> int:
        return self.coordinate(rank)[self.dim_names.index(name)]

    # -- groups ------------------------------------------------------------
    def _build_groups(self):
        """This rank's group along each axis (made or reused, see the
        module docstring); every rank of the world calls it for the same
        mesh, as group creation needs."""
        from . import env

        if not env.is_initialized():
            raise RuntimeError(
                "a ProcessMesh's groups need the process group: call "
                "paddle.distributed.init_parallel_env() (or fleet.init) "
                "first")
        me = self.coordinate()
        groups = []
        for axis in range(self.ndim):
            mine = None
            for ranks in _axis_groups(self._ids, axis):
                g = _group_of(ranks)
                if me is not None and env.get_rank() in ranks:
                    mine = g
            groups.append(mine)
        self._groups = groups

    def set_groups(self, groups):
        """Use ``groups`` (this rank's group along each axis, made by the
        caller, as the fleet topology does) and make none."""
        self._groups = list(groups)

    def get_group(self, name) -> "object":
        """This rank's group along axis ``name`` (a name or an index)."""
        if self._groups is None:
            self._build_groups()
        i = name if isinstance(name, int) else self.dim_names.index(name)
        return self._groups[i]

    def device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` over this mesh's groups
        (on the port's default device type)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh

            from ..device import resolve_device

            if self._groups is None:
                self._build_groups()
            if self.coordinate() is None:
                raise ValueError(f"this rank is not on the mesh "
                                 f"{self.process_ids}")
            dev = resolve_device(None).type
            self._device_mesh = DeviceMesh.from_group(
                [g.process_group for g in self._groups], dev,
                mesh=torch.as_tensor(self._ids),
                mesh_dim_names=tuple(self.dim_names))
        return self._device_mesh

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self.process_ids == other.process_ids
                and self.shape == other.shape)

    def __hash__(self):
        return hash((tuple(self.process_ids), tuple(self.shape)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


def build_mesh(axis_dims: Sequence[int], axis_names: Sequence[str],
               devices: Optional[Sequence[int]] = None) -> ProcessMesh:
    """A mesh of ``axis_dims`` over the ranks ``devices`` (default the
    world) in grid order. Degenerate (size-1) axes are kept, so a spec may
    name any hybrid axis whatever its degree."""
    ranks = list(range(_world_size())) if devices is None else \
        [int(d) for d in devices]
    n = int(np.prod(axis_dims))
    if n != len(ranks):
        raise ValueError(f"mesh axis dims {tuple(axis_dims)} require {n} "
                         f"devices, got {len(ranks)}")
    return ProcessMesh(np.asarray(ranks).reshape(tuple(axis_dims)),
                       dim_names=list(axis_names))


def build_hybrid_mesh(axis_dims, axis_names, devices=None,
                      num_slices: Optional[int] = None) -> ProcessMesh:
    """The rank grid in the order given (one host of cards: no torus to
    honor). ``num_slices > 1`` (the reference's DCN split of a multi-slice
    TPU) raises."""
    if num_slices is not None and int(num_slices) > 1:
        raise NotImplementedError(
            "build_hybrid_mesh(num_slices > 1) lays a mesh over TPU slices "
            "joined by DCN; not ported, see ROADMAP.md §A.7 item 4")
    return build_mesh(axis_dims, axis_names, devices)


def set_global_mesh(mesh: Optional[ProcessMesh]):
    _state.mesh = mesh


def get_global_mesh() -> Optional[ProcessMesh]:
    return getattr(_state, "mesh", None)


def require_global_mesh() -> ProcessMesh:
    m = get_global_mesh()
    if m is None:
        raise RuntimeError(
            "no global mesh: call paddle.distributed.fleet.init() or "
            "set_mesh() first")
    return m


@contextlib.contextmanager
def global_mesh(mesh: ProcessMesh):
    prev = get_global_mesh()
    set_global_mesh(mesh)
    try:
        yield mesh
    finally:
        set_global_mesh(prev)


def hybrid_mesh(hcg) -> ProcessMesh:
    """The mesh of a hybrid topology (made once a topology): its rank grid
    under ``HYBRID_AXES``, each axis on the topology's own group."""
    pm = hcg.__dict__.get("_process_mesh")
    if pm is None:
        from .fleet.topology import _AXIS_ALIAS

        topo = hcg.topology()
        names = [_AXIS_ALIAS[n] for n in topo.get_hybrid_group_names()]
        pm = ProcessMesh(topo._rank_grid, dim_names=names)
        pm.set_groups([hcg._groups.get(n) for n in names])
        hcg._process_mesh = pm
    return pm


def hcg_mesh() -> ProcessMesh:
    """The mesh of the fleet topology in force."""
    from .fleet.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("no fleet topology: call fleet.init() (or "
                           "parallelize) first")
    return hybrid_mesh(hcg)


def _sanitize_spec(spec, shape, mesh) -> Tuple:
    """Drop axis names from dims they do not divide evenly (an indivisible
    dim stays replicated rather than erroring); trailing Nones dropped."""
    sizes = mesh.axis_sizes if hasattr(mesh, "axis_sizes") else dict(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        names = e if isinstance(e, tuple) else ((e,) if e is not None else ())
        size = 1
        for n in names:
            size *= sizes.get(n, 1)
        out.append(None if size > 1 and dim % size != 0 else e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def sharding_constraint(value, spec, mesh: Optional[ProcessMesh] = None):
    """Pin ``value``'s layout to ``spec`` (a tuple of mesh axis names or
    None per dim) on the mesh (default the global one): the identity on a
    plain tensor or with no mesh, ``reshard`` on a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    m = mesh or get_global_mesh()
    if m is None or not isinstance(value, DTensor):
        return value
    from .auto_parallel import reshard, spec_to_placements

    spec = _sanitize_spec(tuple(spec), tuple(value.shape), m)
    return reshard(value, m, spec_to_placements(m, spec))


def mesh_axis_size(name: str, mesh: Optional[ProcessMesh] = None) -> int:
    m = mesh or get_global_mesh()
    if m is None or name not in m.dim_names:
        return 1
    return m.get_dim_size(name)


__all__ = ["HYBRID_AXES", "ProcessMesh", "build_hybrid_mesh", "build_mesh",
           "get_global_mesh", "global_mesh", "mesh_axis_size",
           "require_global_mesh", "set_global_mesh", "sharding_constraint"]
