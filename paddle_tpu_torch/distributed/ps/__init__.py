"""The parameter-server capability (counterpart of
``paddle_tpu/distributed/ps/__init__.py``).

What Paddle's PS mode buys is one capability: embedding tables too large
for one card, updated sparsely by many workers. The reference keeps no
server processes for it: its ``ShardedEmbeddingTable`` partitions the rows
over a mesh axis and lets GSPMD place the gather. The port splits the rows
over the group of one axis of the global ``ProcessMesh``
(``distributed/mesh.py``): the widest of ``sharding`` / ``mp`` / ``dp``,
as the reference picks it. Each rank holds ``num_embeddings / n`` rows; a
lookup gathers the ids that fall in the rank's rows (the others give
zeros) and the rows are all-reduced over the group, whose backward is the
identity: ``fleet/layers/mpu.py``'s ``VocabParallelEmbedding``. So the
ranks of the table's group look up the same ids, as an mp group's ranks
do. Without a global mesh (or when the axis does not divide the rows) the
table is whole. The optimizer step is the one every other parameter takes.

There are no servers to start, so the PS role API (``fleet.init_server``
/ ``run_server`` / ``init_worker`` / ``stop_worker``, ``RoleMakerBase``)
is kept as working no-ops so PS-mode scripts run unchanged.

The async tiers are in ``ps.geo``: ``GeoSGDCommunicator`` (geo-SGD delta
exchange over a store) and ``HostOffloadedTable`` (the host-RAM tier with
rows staged onto the card and row-wise AdaGrad).
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer, create_parameter
from .. import mesh as _mesh
from .geo import (  # noqa: F401  (the async PS tiers)
    GeoSGDCommunicator,
    HostOffloadedTable,
    LocalDeltaStore,
    TCPDeltaStore,
)

__all__ = [
    "ShardedEmbeddingTable",
    "sparse_embedding",
    "RoleMakerBase",
    "table_shard_info",
    "GeoSGDCommunicator",
    "HostOffloadedTable",
    "LocalDeltaStore",
    "TCPDeltaStore",
]


def _table_axis() -> Optional[str]:
    """The mesh axis carrying table rows: the widest of sharding / mp /
    dp of the global mesh (None without one)."""
    m = _mesh.get_global_mesh()
    if m is None:
        return None
    best, width = None, 1
    sizes = m.axis_sizes
    for name in ("sharding", "mp", "dp"):
        if sizes.get(name, 1) > width:
            best, width = name, sizes[name]
    return best


def _lookup(ids: torch.Tensor, weight: torch.Tensor, start: int
            ) -> torch.Tensor:
    """The rows of ``ids`` that fall in ``weight``'s range ``[start, start
    + rows)``, zeros elsewhere. Only those ids reach the embedding (in
    their order), so its backward sums each row's gradients as a whole
    table's lookup of the same ids does."""
    local = ids - start
    inside = (local >= 0) & (local < weight.shape[0])
    sel = inside.nonzero(as_tuple=True)
    rows = F.embedding(local[sel], weight)
    out = weight.new_zeros(tuple(ids.shape) + (weight.shape[1],))
    return out.index_put(sel, rows)


class ShardedEmbeddingTable(Layer):
    """A vocab-row-split embedding table, the PS "distributed table" (see
    the module docstring). ``weight`` is this rank's rows; the whole table
    is drawn from ``generator`` and cut, so one seed gives the same table
    at any split."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, weight_attr=None, dtype="float32",
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = padding_idx
        ax = _table_axis()
        m = _mesh.get_global_mesh()
        self._group, self.world_size, self.rank = None, 1, 0
        if ax is not None and self.num_embeddings % m.get_dim_size(ax) == 0:
            self.world_size = m.get_dim_size(ax)
            self.rank = m.axis_coord(ax)
            self._group = m.get_group(ax)
        else:
            ax = None
        self.axis = ax
        rows = self.num_embeddings // self.world_size
        self.vocab_start = self.rank * rows
        w = create_parameter(
            [self.num_embeddings, self.embedding_dim], weight_attr,
            default_initializer=I.XavierNormal(), device=device,
            dtype=dtype, generator=generator)
        if self.world_size > 1:
            part = type(w)(w.data[self.vocab_start:self.vocab_start + rows]
                           .clone(), trainable=w.trainable)
            part.__dict__.update(w.__dict__)
            w = part
        w.table_shard = dict(axis=ax, num_shards=self.world_size,
                             global_rows=self.num_embeddings)
        self.weight = w

    def forward(self, ids):
        ids = torch.as_tensor(ids, device=self.weight.device)
        if self.world_size == 1:
            out = F.embedding(ids, self.weight)
        else:
            from ..fleet.layers.mpu import _mp_allreduce

            out = _mp_allreduce(_lookup(ids, self.weight, self.vocab_start),
                                self._group)
        if self.padding_idx is not None:
            out = out * (ids != self.padding_idx).unsqueeze(-1).to(out.dtype)
        return out

    def shard_info(self):
        return table_shard_info(self.weight)


_tables: Dict[str, ShardedEmbeddingTable] = {}


def _call_site(prefix: str, name: Optional[str]) -> str:
    """A table's identity: its ``name``, else the caller's code location,
    so the same call re-run each step reuses its table (the reference's
    ``static.nn._auto``)."""
    if name:
        return name
    f = sys._getframe(2)
    return f"{prefix}@{f.f_code.co_filename}:{f.f_lineno}:{f.f_lasti}"


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, param_attr=None, dtype="float32", name=None):
    """``paddle.static.nn.sparse_embedding`` parity, the PS-mode lookup:
    builds (once per call site, or per ``name``) a ShardedEmbeddingTable
    on ``input``'s device and applies it. ``entry`` (frequency-gated row
    admission, which bounds PS server memory) is accepted and ignored:
    the row split bounds it already."""
    key = _call_site("sparse_embedding", name)
    table = _tables.get(key)
    if table is None:
        device = input.device if isinstance(input, torch.Tensor) else None
        table = _tables[key] = ShardedEmbeddingTable(
            size[0], size[1], padding_idx, weight_attr=param_attr,
            dtype=dtype, device=device)
    return table(input)


def table_shard_info(weight) -> dict:
    """Placement report of a table's weight (the PS ``print_table_stats``
    role)."""
    info = getattr(weight, "table_shard", None) or dict(
        axis=None, num_shards=1, global_rows=int(weight.shape[0]))
    n = info["num_shards"]
    rows = info["global_rows"]
    return {
        "global_rows": rows,
        "dim": int(weight.shape[1]),
        "num_shards": n,
        "rows_per_shard": rows // n,
        "axis": info["axis"],
        "bytes_per_shard": rows * int(weight.shape[1])
        * weight.element_size() // n,
    }


class RoleMakerBase:
    """The PS role protocol with collective-runtime semantics: every
    process is a worker; there are no servers."""

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def is_first_worker(self) -> bool:
        from ..env import get_rank

        return get_rank() == 0

    def worker_num(self) -> int:
        from ..env import get_world_size

        return get_world_size()

    def server_num(self) -> int:
        return 0

    def worker_index(self) -> int:
        from ..env import get_rank

        return get_rank()
