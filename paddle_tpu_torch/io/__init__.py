"""Data loading (counterpart of ``paddle_tpu/io/__init__.py``).

Datasets, samplers, ``BatchSampler`` and ``DataLoader`` as in the
reference. The samplers draw from numpy's global RNG as the reference's
do, so under one ``np.random.seed`` both packages visit the same indices
in the same order. ``default_collate_fn`` stacks numpy leaves through
the native batch stacker (``runtime.stack_samples``) into host tensors;
``DataLoader`` then puts every tensor of a batch on its device
(``places`` / ``device``, default the CUDA card): a pinned host copy and
a ``non_blocking`` copy, issued when the batch is pulled, stand in for
the reference's asynchronous ``jnp.asarray``, and the buffered reader
keeps ``prefetch_factor`` batches pulled ahead so that the next batch's
copy overlaps the current step.

``num_workers > 0`` with the default collate runs worker processes
(``io/multiprocess.py``: numpy only, shared-memory transport; the main
process builds the device tensors), falling back to worker threads with a
warning when the processes cannot be set up, as the reference does; a
custom ``collate_fn`` runs on the threads. ``DistributedBatchSampler``
gives one data-parallel rank's batches.
"""
from __future__ import annotations

import collections
import itertools
import math
import queue
import threading
import warnings

import numpy as np
import torch

from ..device import resolve_device


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        if len({t.shape[0] for t in tensors}) != 1:
            raise ValueError("all tensors must share dim0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsum = list(itertools.accumulate(len(d)
                                                for d in self.datasets))

    def __len__(self):
        return self.cumsum[-1]

    def __getitem__(self, idx):
        for i, c in enumerate(self.cumsum):
            if idx < c:
                prev = self.cumsum[i - 1] if i else 0
                return self.datasets[i][idx - prev]
        raise IndexError(idx)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ComposeDataset(Dataset):
    """Zip datasets sample-wise: item i concatenates every dataset's
    fields at index i."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("ComposeDataset datasets must share a length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


def _rng(generator):
    """numpy's global RNG, or the ``np.random.Generator`` /
    ``RandomState`` given."""
    return np.random if generator is None else generator


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths over one permutation. The
    permutation is numpy's (the reference draws it from its JAX key, so
    the two packages split differently)."""
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = _rng(generator).permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) of the
    indices from numpy's global RNG, or from ``generator`` (a numpy
    ``Generator`` / ``RandomState``) where given: the reference ignores
    ``generator`` (ROADMAP.md §C)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = generator

    def __iter__(self):
        n = len(self.data_source)
        rng = _rng(self.generator)
        if self.replacement:
            draw = (rng.integers if hasattr(rng, "integers")
                    else rng.randint)
            return iter(draw(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     self.replacement, p).tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A fixed index subset, shuffled each epoch."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter(self.indices[i]
                    for i in np.random.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """The batches of one data-parallel rank (reference
    ``paddle_tpu/io/__init__.py:217``): the indices, shuffled by
    ``RandomState(epoch)`` when ``shuffle``, padded by wrapping to a
    multiple of ``num_replicas``, then every ``num_replicas``-th from
    ``rank``. ``num_replicas`` and ``rank`` default to the data-parallel
    degree and rank (the data and sharding axes of ``fleet.init``'s
    topology), else the world size and rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size
            from ..distributed.fleet import get_hybrid_communicate_group

            hcg = get_hybrid_communicate_group()
            if num_replicas is None:
                num_replicas = (
                    hcg.get_data_sharding_parallel_world_size()
                    if hcg is not None else get_world_size())
            if rank is None:
                rank = (hcg.get_data_sharding_parallel_rank()
                        if hcg is not None else get_rank())
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def _np_leaf(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def default_collate_fn(batch):
    """Stack a list of samples into one batch, by structure: arrays and
    tensors into a host tensor through the native batch stacker
    (``runtime.stack_samples``; ``np.stack`` without it), numbers into a
    1-D tensor, tuples / lists / dicts field by field; strings and other
    objects stay a list."""
    from ..runtime import stack_samples

    sample = batch[0]
    if isinstance(sample, (torch.Tensor, np.ndarray)):
        return torch.from_numpy(stack_samples([_np_leaf(b) for b in batch]))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(s))
                            for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _place(tree, device):
    """Every tensor of ``tree`` on ``device``; a host tensor bound for the
    card goes through a pinned copy and a ``non_blocking`` copy."""
    if isinstance(tree, torch.Tensor):
        if tree.device == device:
            return tree
        if device.type == "cuda" and tree.device.type == "cpu":
            pinned = tree if tree.is_pinned() else tree.pin_memory()
            return pinned.to(device, non_blocking=True)
        return tree.to(device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    return tree


class DataLoader:
    """Batches of ``dataset`` on ``device`` (Paddle's ``places``; default
    the CUDA card)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device=None):
        if device is None and places is not None:
            device = places[0] if isinstance(places, (list, tuple)) \
                else places
        self.device = resolve_device(device)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = max(2, prefetch_factor)
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._mp_pool = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _gen_batches(self):
        """Collated host batches, in order."""
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _buffered(self, it):
        """The buffered reader: batches placed on the device as they are
        pulled, ``prefetch_factor`` of them ahead of the consumer, so the
        copy of batch k+1 is issued before the step on batch k."""
        placed = (_place(b, self.device) for b in it)
        if self.use_buffer_reader:
            return _lookahead_batches(placed, self.prefetch_factor)
        return placed

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._buffered(self._gen_batches())
            return
        if not self._iterable_mode and self.collate_fn is default_collate_fn:
            try:
                yield from self._buffered(self._iter_multiprocess())
                return
            except _MpSetupError as e:
                warnings.warn(
                    f"multiprocess DataLoader unavailable ({e.__cause__}); "
                    "falling back to worker threads (GIL-bound for "
                    "Python-heavy transforms)")
        for out in self._iter_threads():
            yield _place(out, self.device)

    def _iter_threads(self):
        """Host batches from ``num_workers`` threads, in order."""
        if self._iterable_mode:
            q: "queue.Queue" = queue.Queue(
                maxsize=self.num_workers * self.prefetch_factor)
            stop = object()

            def produce():
                try:
                    for b in self._gen_batches():
                        q.put(b)
                finally:
                    q.put(stop)

            threading.Thread(target=produce, daemon=True).start()
            while True:
                item = q.get()
                if item is stop:
                    return
                yield item

        idx_q: "queue.Queue" = queue.Queue()
        batches = list(self.batch_sampler)
        for i, idxs in enumerate(batches):
            idx_q.put((i, idxs))
        results = {}
        res_cv = threading.Condition(threading.Lock())

        def worker():
            while True:
                try:
                    i, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    out = self.collate_fn([self.dataset[j] for j in idxs])
                except BaseException as e:  # propagate, else the loop hangs
                    out = _WorkerFailure(e)
                with res_cv:
                    results[i] = out
                    res_cv.notify_all()

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()
        for i in range(len(batches)):
            with res_cv:
                while i not in results:
                    res_cv.wait()
                out = results.pop(i)
            if isinstance(out, _WorkerFailure):
                raise RuntimeError(
                    f"DataLoader worker failed on batch {i}") from out.exc
            yield out

    # ------------------------------------------------- multiprocess path ----
    def _get_mp_pool(self):
        from .multiprocess import MultiprocessWorkerPool, _np_collate

        pool = self._mp_pool
        if pool is not None and not pool._closed:
            return pool
        try:
            pool = MultiprocessWorkerPool(
                self.dataset, _np_collate, self.num_workers,
                self.prefetch_factor, worker_init_fn=self.worker_init_fn,
                use_shared_memory=self.use_shared_memory)
        except Exception as e:  # process / pickling set-up -> threads
            raise _MpSetupError() from e
        self._mp_pool = pool
        return pool

    def _iter_multiprocess(self):
        """Host batches from the worker processes, in order: each numpy
        leaf copied out of its shared-memory segment (pinned when bound
        for the card), then the segment released."""
        from .multiprocess import MultiprocessWorkerPool

        pin = self.device.type == "cuda"
        pool = self._get_mp_pool()
        try:
            for tree, opened in pool.run_epoch(self.batch_sampler):
                out = _host_tree(tree, pin)
                MultiprocessWorkerPool.release(opened)
                yield out
        finally:
            if not self.persistent_workers:
                pool.close()
                self._mp_pool = None


class _MpSetupError(Exception):
    pass


class _WorkerFailure:
    def __init__(self, exc):
        self.exc = exc


def _lookahead_batches(it, depth):
    """Yield from ``it`` keeping ``depth`` items pulled ahead. A mid-stream
    error of the source is raised after the batches already pulled have
    been delivered: the consumer loses none it would have had unbuffered."""
    buf = collections.deque()
    pending_err = None
    try:
        while len(buf) < depth:
            buf.append(next(it))
    except StopIteration:
        pass
    except Exception as e:  # noqa: BLE001 — re-raised after the drain
        pending_err = e
    while buf:
        out = buf.popleft()
        if pending_err is None:
            try:
                buf.append(next(it))
            except StopIteration:
                pass
            except Exception as e:  # noqa: BLE001
                pending_err = e
        yield out
    if pending_err is not None:
        raise pending_err


def _host_tree(tree, pin):
    """numpy leaves -> host tensors holding their own copy (the source may
    be a view of a shared-memory segment released right after)."""
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(tree)
        return t.pin_memory() if pin else t.clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(x, pin) for x in tree)
    if isinstance(tree, dict):
        return {k: _host_tree(v, pin) for k, v in tree.items()}
    return tree


def get_worker_info():
    """The ``WorkerInfo`` of the worker process calling, else None."""
    from .multiprocess import get_worker_info as _gwi

    return _gwi()


__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "get_worker_info", "random_split"]
