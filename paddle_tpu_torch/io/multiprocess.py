"""Multiprocess DataLoader workers with shared-memory transport
(counterpart of ``paddle_tpu/io/multiprocess.py``).

Map-style datasets run in worker *processes*, so Python-heavy transforms
scale past the GIL:
  * worker processes (fork where the platform has it) run ``dataset[i]``
    and collate to NUMPY ONLY: they never touch the CUDA card (a forked
    child must not use the parent's CUDA context);
  * each collated ndarray is written to a ``multiprocessing.shared_memory``
    segment; only (name, shape, dtype) descriptors cross the result queue;
  * the parent maps the segment, copies it into a (pinned) host tensor,
    which ``DataLoader`` sends to the card, then unlinks it;
  * batch order is restored parent-side; a bounded feeder keeps at most
    ``num_workers * prefetch_factor`` batches in flight.

Worker exceptions travel back as tracebacks and re-raise in the parent. A
pool serves one epoch, or several with ``persistent_workers``.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import threading
import traceback
from multiprocessing import shared_memory
from typing import Any, Callable, Optional

import numpy as np
import torch

_SHM_MIN_BYTES = 1024  # below this, pickling through the queue is cheaper


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return f"WorkerInfo(id={self.id}, num_workers={self.num_workers})"


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """The worker's ``WorkerInfo`` inside a worker process, else None."""
    return _worker_info


def _np_collate(batch):
    """The default collate in numpy only: samples that are host tensors
    are read as arrays; a CUDA tensor raises (a worker must not touch the
    card)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        if sample.device.type != "cpu":
            raise TypeError(
                "dataset __getitem__ returned a tensor on "
                f"{sample.device}; with num_workers > 0 samples must be "
                "numpy arrays, numbers or host tensors (a forked worker "
                "must not use the card). Return np.ndarray, or use "
                "num_workers=0.")
        return np.stack([b.numpy() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(_np_collate(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch]) for k in sample}
    return batch  # strings and opaque objects pass through


def _encode(tree, segments, shm_min_bytes=_SHM_MIN_BYTES):
    """ndarray leaves → shm descriptors; everything else pickles inline."""
    if isinstance(tree, np.ndarray) and tree.nbytes >= shm_min_bytes:
        seg = shared_memory.SharedMemory(create=True, size=tree.nbytes)
        np.ndarray(tree.shape, tree.dtype, buffer=seg.buf)[...] = tree
        segments.append(seg)
        return ("shm", seg.name, tree.shape, str(tree.dtype))
    if isinstance(tree, np.ndarray):
        return ("arr", tree)
    if isinstance(tree, (list, tuple)):
        return (
            "seq", type(tree).__name__,
            [_encode(x, segments, shm_min_bytes) for x in tree],
        )
    if isinstance(tree, dict):
        return ("map", {
            k: _encode(v, segments, shm_min_bytes) for k, v in tree.items()
        })
    return ("obj", tree)


def _decode(node, opened):
    tag = node[0]
    if tag == "shm":
        _, name, shape, dtype = node
        seg = shared_memory.SharedMemory(name=name)
        opened.append(seg)
        return np.ndarray(shape, np.dtype(dtype), buffer=seg.buf)
    if tag == "arr" or tag == "obj":
        return node[1]
    if tag == "seq":
        _, tname, items = node
        seq = [_decode(x, opened) for x in items]
        return tuple(seq) if tname == "tuple" else seq
    if tag == "map":
        return {k: _decode(v, opened) for k, v in node[1].items()}
    raise ValueError(f"bad payload tag {tag!r}")


def _worker_loop(worker_id, num_workers, dataset, collate, idx_q, res_q,
                 worker_init_fn, shm_min_bytes):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        task = idx_q.get()
        if task is None:
            return
        bi, idxs = task
        try:
            out = collate([dataset[j] for j in idxs])
            segments = []
            payload = _encode(out, segments, shm_min_bytes)
            res_q.put((bi, "ok", payload))
            # close OUR mapping and hand ownership to the parent (it unlinks
            # after the device copy); unregister from this process's
            # resource_tracker so it doesn't warn about/destroy segments it
            # no longer owns at shutdown
            for seg in segments:
                seg.close()
                try:
                    from multiprocessing import resource_tracker

                    resource_tracker.unregister(seg._name, "shared_memory")
                except Exception:
                    pass
        except Exception:
            res_q.put((bi, "err", traceback.format_exc()))


class MultiprocessWorkerPool:
    """Worker-process pool serving ordered, bounded-in-flight batch epochs.

    Reusable across epochs (``persistent_workers``): the fork is paid once,
    not per ``__iter__``.
    """

    def __init__(self, dataset, collate_np: Callable, num_workers: int,
                 prefetch_factor: int, worker_init_fn=None,
                 use_shared_memory=True):
        ctx = mp.get_context(
            "fork" if "fork" in mp.get_all_start_methods() else "spawn"
        )
        self._inflight_cap = max(2, num_workers * prefetch_factor)
        self._idx_q = ctx.Queue()
        self._res_q = ctx.Queue()
        self._procs = [
            ctx.Process(
                target=_worker_loop,
                args=(w, num_workers, dataset, collate_np, self._idx_q,
                      self._res_q, worker_init_fn,
                      _SHM_MIN_BYTES if use_shared_memory else float("inf")),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        for p in self._procs:
            p.start()
        self._closed = False

    def run_epoch(self, batches):
        """Yield (numpy_tree, opened_segments) for each batch, in order."""
        batches = list(batches)
        n = len(batches)
        sent = received = 0
        pending = {}
        try:
            for i in range(min(self._inflight_cap, n)):
                self._idx_q.put((i, batches[i]))
                sent += 1
            for want in range(n):
                while want not in pending:
                    try:
                        bi, status, payload = self._res_q.get(timeout=5.0)
                    except queue.Empty:
                        # no result: make sure the workers are still alive —
                        # an OOM-killed/segfaulted child never reports, and
                        # a bare get() would hang the training job forever
                        dead = [p for p in self._procs if not p.is_alive()]
                        if dead:
                            self.close()
                            raise RuntimeError(
                                f"{len(dead)} DataLoader worker(s) died "
                                f"(exitcodes {[p.exitcode for p in dead]}) "
                                "without reporting a result"
                            )
                        continue
                    received += 1
                    if status == "err":
                        self._drain(sent - received, pending)
                        self.close()
                        raise RuntimeError(
                            f"DataLoader worker failed on batch {bi}:\n"
                            f"{payload}")
                    pending[bi] = payload
                    if sent < n:
                        self._idx_q.put((sent, batches[sent]))
                        sent += 1
                opened = []
                tree = _decode(pending.pop(want), opened)
                yield tree, opened  # caller converts + then release(opened)
        except GeneratorExit:
            # consumer abandoned the epoch: drain in-flight work so the pool
            # stays reusable, releasing any shm still in transit
            self._drain(sent - received, pending)
            raise

    def _drain(self, outstanding, pending):
        """Release shm of `pending` (received) payloads and absorb
        `outstanding` not-yet-received results."""
        for payload in pending.values():
            opened = []
            try:
                _decode(payload, opened)
            finally:
                self.release(opened)
        pending.clear()
        for _ in range(max(outstanding, 0)):
            try:
                bi, status, payload = self._res_q.get(timeout=30)
            except Exception:
                self.close()
                return
            if status == "ok":
                opened = []
                try:
                    _decode(payload, opened)
                finally:
                    self.release(opened)

    @staticmethod
    def release(opened):
        for seg in opened:
            try:
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            try:
                self._idx_q.put(None)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        # drain any straggler shm descriptors so segments don't leak
        try:
            while True:
                bi, status, payload = self._res_q.get_nowait()
                if status == "ok":
                    opened = []
                    _decode(payload, opened)
                    self.release(opened)
        except Exception:  # queue.Empty, or anything mid-interpreter-exit
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # module globals may be gone at interpreter exit
            pass
