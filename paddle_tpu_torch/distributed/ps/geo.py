"""Async push / pull parameter-server tiers (counterpart of
``paddle_tpu/distributed/ps/geo.py``).

Reference capability: the async PS modes of
``paddle/fluid/distributed/ps/service/communicator/``, geo-SGD (each
trainer trains a full local copy and exchanges accumulated deltas every k
steps), and the heter-PS cache tiers (``paddle/fluid/framework/fleet/
heter_ps/``: tables too large for device memory live in host RAM, hot
rows are staged onto the card).

- ``GeoSGDCommunicator``: geo-SGD with SERVERLESS peer merge. Each worker
  keeps a base snapshot of the table; ``push()`` publishes (local - base)
  of the touched rows to a DeltaStore, ``pull()`` folds every peer's new
  deltas into the local copy. The additive merge is geo-SGD's server-side
  rule, so the store can be a plain KV (an in-process dict, or
  ``runtime.TCPStore`` across processes).
- ``HostOffloadedTable``: the heter-PS host tier for one card: rows live in
  host RAM (numpy), ``pull(ids)`` stages the unique hot rows onto the
  device for the step, ``push(ids, grads)`` applies row-wise AdaGrad on
  the host. The card holds only the working set.

Deliberately absent, as in the reference: the brpc transport, the SSD
tier, server-side fused optimizers; the synchronous split table
(``ps/__init__.py::ShardedEmbeddingTable``) is the first choice.
"""
from __future__ import annotations

import io
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "LocalDeltaStore",
    "TCPDeltaStore",
    "GeoSGDCommunicator",
    "HostOffloadedTable",
]


def _pack(ids: np.ndarray, delta: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, ids=ids, delta=delta)
    return buf.getvalue()


def _unpack(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(io.BytesIO(blob)) as z:
        return z["ids"], z["delta"]


class LocalDeltaStore:
    """In-process DeltaStore: one dict shared by every communicator in the
    process (the single-process transport). Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blobs: Dict[str, bytes] = {}
        self._rounds: Dict[Tuple[str, int], int] = {}  # (table, worker) -> n

    def publish(self, table: str, worker: int, blob: bytes) -> int:
        with self._lock:
            n = self._rounds.get((table, worker), 0)
            self._blobs[f"{table}/{worker}/{n}"] = blob
            self._rounds[(table, worker)] = n + 1
            return n

    def rounds_of(self, table: str, worker: int) -> int:
        with self._lock:
            return self._rounds.get((table, worker), 0)

    def fetch(self, table: str, worker: int, rnd: int) -> Optional[bytes]:
        with self._lock:
            return self._blobs.get(f"{table}/{worker}/{rnd}")


class TCPDeltaStore:
    """DeltaStore over ``runtime.TCPStore``: the cross-process transport. Keys: ``geo/{table}/{worker}/{round}`` carry
    the delta blob; ``geo/{table}/{worker}/n`` counts published rounds
    (via the store's atomic add)."""

    def __init__(self, store):
        self._s = store

    def publish(self, table: str, worker: int, blob: bytes) -> int:
        n = self._s.add(f"geo/{table}/{worker}/n", 1) - 1
        self._s.set(f"geo/{table}/{worker}/{n}", blob)
        return n

    def rounds_of(self, table: str, worker: int) -> int:
        # atomic add of 0 reads the counter without waiting on a set
        return self._s.add(f"geo/{table}/{worker}/n", 0)

    def fetch(self, table: str, worker: int, rnd: int) -> Optional[bytes]:
        try:
            return bytes(self._s.get(f"geo/{table}/{worker}/{rnd}", timeout=30.0))
        except Exception:
            return None


class GeoSGDCommunicator:
    """Geo-SGD async table sync (reference: geo mode of
    ``distributed/ps/service/communicator``), serverless.

    Usage per worker::

        comm = GeoSGDCommunicator(table, store, worker_id=r, num_workers=W,
                                  sync_every=k)
        for step, batch in enumerate(data):
            rows = train_on(comm.table, batch)     # local dense/sparse math
            comm.touch(rows)                       # rows this worker changed
            comm.step()                            # pushes+pulls every k

    ``table`` is mutated IN PLACE (numpy [vocab, dim]); after a sync the
    local copy equals base + every worker's published deltas (applied
    additively, the geo merge rule).
    """

    def __init__(self, table: np.ndarray, store, worker_id: int,
                 num_workers: int, sync_every: int = 8, name: str = "table"):
        self.table = table
        self._base = table.copy()
        self._store = store
        self.worker_id = int(worker_id)
        self.num_workers = int(num_workers)
        self.sync_every = max(1, int(sync_every))
        self.name = name
        self._touched: set = set()
        self._step = 0
        self._seen_rounds = [0] * self.num_workers

    def touch(self, ids) -> None:
        self._touched.update(int(i) for i in np.atleast_1d(np.asarray(ids)).ravel())

    def step(self) -> bool:
        self._step += 1
        if self._step % self.sync_every != 0:
            return False
        self.sync()
        return True

    def push(self) -> None:
        ids = np.fromiter(sorted(self._touched), dtype=np.int64,
                          count=len(self._touched))
        delta = (self.table[ids] - self._base[ids]) if len(ids) else \
            np.zeros((0, self.table.shape[1]), self.table.dtype)
        rnd = self._store.publish(self.name, self.worker_id, _pack(ids, delta))
        # fold our published delta into base NOW and mark it seen — pull()
        # computes local drift as (table - base); leaving the pushed delta
        # in the drift while also fetching it back would double-count it
        if len(ids):
            np.add.at(self._base, ids, delta)
        self._seen_rounds[self.worker_id] = rnd + 1
        self._touched.clear()

    def pull(self) -> None:
        """Fold every peer's unseen deltas (and our own published ones) into
        base, then re-apply our local unpublished drift on top."""
        local_drift = self.table - self._base
        for w in range(self.num_workers):
            upto = self._store.rounds_of(self.name, w)
            for rnd in range(self._seen_rounds[w], upto):
                blob = self._store.fetch(self.name, w, rnd)
                if blob is None:
                    continue
                ids, delta = _unpack(blob)
                if len(ids):
                    np.add.at(self._base, ids, delta.astype(self._base.dtype))
            self._seen_rounds[w] = upto
        np.copyto(self.table, self._base + local_drift)

    def sync(self) -> None:
        self.push()
        self.pull()


class HostOffloadedTable:
    """Heter-PS host-memory tier for one accelerator: a [vocab, dim] table
    in host RAM with device-staged lookups and host-side rowwise-AdaGrad
    updates (reference: ``heter_ps`` HBM/host cache,
    ``CtrDymfAccessor``-style sparse optimizer).

    ``pull(ids)`` -> device array of the unique rows (plus the inverse map
    to expand per-position); ``push(unique_ids, row_grads)`` applies
    AdaGrad on host. The device never holds more than the batch's working
    set. Optionally wired to a GeoSGDCommunicator for async multi-worker
    sync of the host table.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 lr: float = 0.05, initializer=None, dtype="float32",
                 seed: int = 0, geo: Optional[GeoSGDCommunicator] = None,
                 device=None):
        rng = np.random.default_rng(seed)
        scale = 1.0 / np.sqrt(embedding_dim)
        self.table = (initializer if initializer is not None else
                      rng.uniform(-scale, scale,
                                  (num_embeddings, embedding_dim))).astype(dtype)
        self.lr = float(lr)
        self._g2 = np.zeros(num_embeddings, dtype)  # AdaGrad row accumulators
        self.geo = geo
        if geo is not None:
            geo.table = self.table  # share storage
        self._device = device

    @property
    def device(self) -> torch.device:
        """Where the staged rows go: the default device (the card) unless
        the caller gave one."""
        from ...device import resolve_device

        return resolve_device(self._device)

    def pull(self, ids):
        """ids: int array [...]; returns (device rows [n_unique, dim],
        unique ids [n_unique], inverse map with ids' shape)."""
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else ids)
        uniq, inv = np.unique(ids.ravel(), return_inverse=True)
        rows = torch.as_tensor(self.table[uniq], device=self.device)
        return rows, uniq, inv.reshape(ids.shape)

    def lookup(self, ids):
        """Convenience: the whole [..., dim] gather on the device (pull +
        expand)."""
        rows, _, inv = self.pull(ids)
        return rows[torch.as_tensor(inv, device=rows.device)]

    def push(self, unique_ids, row_grads) -> None:
        """Rowwise AdaGrad: g2[i] += mean(grad_i^2); row -= lr*g/sqrt(g2+eps).
        ``row_grads`` aligns with ``unique_ids`` (sum-reduced per unique id,
        as returned by a grad of the pull output)."""
        if isinstance(row_grads, torch.Tensor):
            row_grads = row_grads.detach().cpu().numpy()
        if isinstance(unique_ids, torch.Tensor):
            unique_ids = unique_ids.cpu().numpy()
        ids = np.asarray(unique_ids).ravel()
        g = np.asarray(row_grads, self.table.dtype)
        self._g2[ids] += (g * g).mean(axis=-1)
        self.table[ids] -= (
            self.lr * g / np.sqrt(self._g2[ids] + 1e-10)[:, None])
        if self.geo is not None:
            self.geo.touch(ids)
            self.geo.step()

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"table": self.table, "g2": self._g2}

    def set_state_dict(self, s) -> None:
        np.copyto(self.table, np.asarray(s["table"], self.table.dtype))
        np.copyto(self._g2, np.asarray(s["g2"], self._g2.dtype))
