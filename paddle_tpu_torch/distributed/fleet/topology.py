"""Hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/fleet/topology.py``).

``CommunicateTopology`` lays the ranks out on a grid of named axes, in the
order ``(data, pipe, sharding, sep, model)`` with ``model`` (mp)
innermost, as the reference's ``fleet.init`` builds it: the mp ranks of
one group are neighbours. ``HybridCommunicateGroup`` gives this rank's
coordinate and, per axis, the group of ranks that differ from it only on
that axis. Each group is a ``torch.distributed`` process group; every
process creates all of them (each axis's slices in ``get_comm_list``
order, then the fused groups), in the same order, as
``torch.distributed.new_group`` requires. The fused data group spans the
``data`` and ``sharding`` axes: the batch's rows are split over it. The
fused data x sep group adds the ``sep`` axis, over which the sequence is
split: the loss and the replicated parameters' gradients are averaged over
it. The expert axis is the first of ``sharding``, ``data``, ``sep`` whose
degree is above 1 (the reference's ``incubate/moe.py::_expert_axis``): a
MoE layer's experts are split over its group, and the expert replica group
(the data x sep ranks that hold the same experts) averages their
gradients.

Without an initialized process group (``torch.distributed`` not set up)
the groups hold their rank lists only, for inspecting a layout.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..env import Group, get_rank, new_group

_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
               "sep": "sep", "model": "mp"}


class CommunicateTopology:
    def __init__(
        self,
        hybrid_group_names: Sequence[str] = ("data", "pipe", "sharding",
                                             "sep", "model"),
        dims: Sequence[int] = (1, 1, 1, 1, 1),
    ):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = itertools.product(*(range(d) for d in self._dims))
        self._world_size = int(np.prod(self._dims))
        self._rank_grid = np.arange(self._world_size).reshape(self._dims)
        self._coord_of_rank = {
            int(self._rank_grid[c]): c
            for c in itertools.product(*(range(d) for d in self._dims))}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return int(self._rank_grid[coord])

    def get_coord(self, rank: int):
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        take = np.take(self._rank_grid, index, axis=axis)
        return [int(r) for r in take.ravel()]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """All groups along ``axis_name``: ranks varying only on it."""
        return self.get_fused_comm_list([axis_name])

    def get_fused_comm_list(self, axis_names: Sequence[str]
                            ) -> List[List[int]]:
        """All groups over several axes: ranks varying only on those, in
        grid order (the first named axis outermost)."""
        axes = sorted(self._parallel_names.index(a) for a in axis_names)
        size = int(np.prod([self._dims[a] for a in axes]))
        moved = np.moveaxis(self._rank_grid, axes,
                            range(-len(axes), 0)).reshape(-1, size)
        return [[int(r) for r in row] for row in moved]


class HybridCommunicateGroup:
    """This rank's coordinate and per-axis groups over the topology."""

    def __init__(self, topology: CommunicateTopology,
                 global_rank: Optional[int] = None):
        self._topo = topology
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        live = dist.is_initialized()
        if live and dist.get_world_size() != self.nranks:
            raise ValueError(
                f"hybrid topology spans {self.nranks} ranks but the world "
                f"has {dist.get_world_size()}; the degrees must multiply to "
                "the world size")
        self.global_rank = get_rank() if global_rank is None else global_rank
        self._coord = topology.get_coord(self.global_rank)
        self._dp_degree = self._dim("data")
        self._pp_degree = self._dim("pipe")
        self._sharding_degree = self._dim("sharding")
        self._sep_degree = self._dim("sep")
        self._mp_degree = self._dim("model")
        self._groups: Dict[str, Group] = {}
        lists = [(_AXIS_ALIAS[n], topology.get_comm_list(n)) for n in names]
        fused = [n for n in ("data", "sharding") if n in names]
        lists.append(("dp_sharding", topology.get_fused_comm_list(fused)))
        tokens = [n for n in ("data", "sharding", "sep") if n in names]
        lists.append(("dp_sep", topology.get_fused_comm_list(tokens)))
        self._expert_axis = next(
            (n for n in ("sharding", "data", "sep") if self._dim(n) > 1),
            None)
        lists.append(("expert_replica", topology.get_fused_comm_list(
            [n for n in tokens if n != self._expert_axis])))
        lists.append(("slice_replica", topology.get_fused_comm_list(
            [n for n in tokens if n != "sharding"])))
        for axis, comm_lists in lists:
            for ranks in comm_lists:
                g = new_group(ranks) if live else Group(ranks)
                if self.global_rank in ranks:
                    g.name = f"{axis}_group"
                    self._groups[axis] = g

    def _dim(self, name):
        names = self._topo.get_hybrid_group_names()
        return self._topo.get_dim(name) if name in names else 1

    def _axis_coord(self, name):
        names = self._topo.get_hybrid_group_names()
        return self._coord[names.index(name)] if name in names else 0

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "model"
        return "data"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._axis_coord("data")

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    # the batch's split: the data and sharding axes together
    def get_data_sharding_parallel_rank(self):
        return (self.get_data_parallel_rank() * self._sharding_degree
                + self.get_sharding_parallel_rank())

    def get_data_sharding_parallel_world_size(self):
        return self._dp_degree * self._sharding_degree

    def get_data_sharding_parallel_group(self) -> Group:
        return self._groups["dp_sharding"]

    # the tokens' split: the data, sharding and sep axes together
    def get_dp_sep_parallel_world_size(self):
        return self.get_data_sharding_parallel_world_size() \
            * self._sep_degree

    def get_dp_sep_parallel_group(self) -> Group:
        return self._groups["dp_sep"]

    # experts: the axis they are split over, its group, and the ranks that
    # hold the same experts
    def get_expert_parallel_axis(self) -> Optional[str]:
        return self._expert_axis

    def get_expert_parallel_rank(self):
        ax = self._expert_axis
        return 0 if ax is None else self._axis_coord(ax)

    def get_expert_parallel_group(self) -> Optional[Group]:
        ax = self._expert_axis
        return None if ax is None else self._groups[_AXIS_ALIAS[ax]]

    def get_expert_replica_group(self) -> Group:
        return self._groups["expert_replica"]

    def get_slice_replica_group(self) -> Group:
        """The ranks that hold the same ZeRO-3 slices: data x sep at this
        sharding coordinate."""
        return self._groups["slice_replica"]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._axis_coord("model")

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    # pipeline
    def get_stage_id(self):
        return self._axis_coord("pipe")

    get_pipe_parallel_rank = get_stage_id

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    get_p2p_groups = get_pipe_parallel_group

    # sharding
    def get_sharding_parallel_rank(self):
        return self._axis_coord("sharding")

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    # sep
    def get_sep_parallel_rank(self):
        return self._axis_coord("sep")

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_check_parallel_group(self, *a, **k) -> Group:
        return self._groups["mp"]

    def get_rank_from_stage(self, stage_id, **kwargs):
        names = self._topo.get_hybrid_group_names()
        coord = dict(zip(names, self._coord))
        coord["pipe"] = stage_id
        coord.update(kwargs)
        return self._topo.get_rank(**coord)


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    """Put ``hcg`` in force, and its mesh as the global mesh (None: no
    topology and no global mesh), as the reference's
    ``HybridCommunicateGroup`` sets its mesh."""
    from ..mesh import hybrid_mesh, set_global_mesh

    global _hcg
    _hcg = hcg
    set_global_mesh(hybrid_mesh(hcg) if hcg is not None else None)


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
