"""Data loading of the PyTorch port (``paddle_tpu_torch/io``) against the
reference's ``paddle_tpu.io`` on the same numpy data and numpy seed:
samplers, ``BatchSampler``, the datasets, ``default_collate_fn``, and
``DataLoader`` at ``num_workers`` 0 and 2 (worker processes, and threads
for a custom collate or an iterable dataset), which must give the same
batches in the same order. The port's batches land on the device given
(the CPU here); without it the card is required."""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu import io as rio
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import multiprocess as tmp

N = 23


class ArrayDataset:
    """A map-style dataset of (features, label) numpy pairs; shared as is
    by both packages (each wants only ``__getitem__`` / ``__len__``)."""

    def __init__(self, n=N, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 3, 4)).astype(np.float32)
        self.y = rng.integers(0, 5, (n,))

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.y)


class DictDataset(ArrayDataset):
    def __getitem__(self, i):
        return {"x": self.x[i], "y": int(self.y[i]), "id": f"s{i}"}


def _ref_ds(cls, *a):
    return type(f"Ref{cls.__name__}", (cls, rio.Dataset), {})(*a)


def _port_ds(cls, *a):
    return type(f"Port{cls.__name__}", (cls, tio.Dataset), {})(*a)


def _np(tree):
    """A batch of either package as nested lists / dicts of numpy."""
    if isinstance(tree, Tensor):
        return np.asarray(raw(tree))
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "cpu"
        return tree.numpy()
    if isinstance(tree, (list, tuple)):
        return [_np(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.shape == want.shape
        # ids are int64 here and int32 in the reference (no x64 in JAX)
        np.testing.assert_array_equal(got, want)
        assert got.dtype.kind == want.dtype.kind
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    else:
        assert got == want


SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random-n": lambda io, ds: io.RandomSampler(ds, num_samples=7),
    "random-replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=30),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 2.0, N), 40),
    "weighted-no-replacement": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 2.0, N), 9, replacement=False),
    "subset": lambda io, ds: io.SubsetRandomSampler([3, 5, 8, 13, 21]),
    "batch": lambda io, ds: io.BatchSampler(ds, batch_size=4),
    "batch-shuffle-drop": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=5, drop_last=True),
    "batch-of-sampler": lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds, num_samples=11), batch_size=3),
}


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_order_matches_reference(name):
    ds = ArrayDataset()
    ref, port = SAMPLERS[name](rio, ds), SAMPLERS[name](tio, ds)
    for epoch in range(2):
        np.random.seed(11 + epoch)
        want = list(ref)
        np.random.seed(11 + epoch)
        assert list(port) == want
    assert len(port) == len(ref)


def test_random_sampler_generator_is_honoured():
    ds = ArrayDataset()
    a = list(tio.RandomSampler(ds, generator=np.random.default_rng(4)))
    b = list(tio.RandomSampler(ds, generator=np.random.default_rng(4)))
    assert a == b and sorted(a) == list(range(N))


def test_random_split_partitions_the_dataset():
    np.random.seed(2)
    parts = tio.random_split(ArrayDataset(), [10, 8, 5])
    idx = [i for p in parts for i in p.indices]
    assert [len(p) for p in parts] == [10, 8, 5]
    assert sorted(idx) == list(range(N))
    with pytest.raises(ValueError):
        tio.random_split(ArrayDataset(), [3, 4])


def test_datasets_match_reference():
    a, b = ArrayDataset(7, seed=1), ArrayDataset(5, seed=2)
    xs = a.x
    cases = [
        (rio.TensorDataset([xs, a.y]), tio.TensorDataset([xs, a.y])),
        (rio.Subset(a, [4, 0, 2]), tio.Subset(a, [4, 0, 2])),
        (rio.ConcatDataset([a, b]), tio.ConcatDataset([a, b])),
        (rio.ComposeDataset([a, a]), tio.ComposeDataset([a, a])),
    ]
    for ref, port in cases:
        assert len(port) == len(ref)
        for i in range(len(ref)):
            _assert_same(_np(list(port[i])), _np(list(ref[i])))
    # (a comprehension: list() asks for a length, which an iterable
    # dataset refuses)
    chain_ref = [x for x in rio.ChainDataset([[1, 2], [3]])]
    assert [x for x in tio.ChainDataset([[1, 2], [3]])] == chain_ref
    with pytest.raises(IndexError):
        tio.ConcatDataset([a, b])[12]
    with pytest.raises(ValueError):
        tio.ComposeDataset([a, b])


def test_default_collate_matches_reference():
    ds = DictDataset(4)
    batch = [ds[i] for i in range(4)]
    _assert_same(_np(tio.default_collate_fn(batch)),
                 _np(rio.default_collate_fn(batch)))
    pairs = [ArrayDataset(3)[i] for i in range(3)]
    got = tio.default_collate_fn(pairs)
    assert isinstance(got, tuple) and isinstance(got[0], torch.Tensor)
    _assert_same(_np(got), _np(rio.default_collate_fn(pairs)))
    # host tensors stack like arrays
    ts = [torch.arange(3) + i for i in range(2)]
    assert tio.default_collate_fn(ts).tolist() == [[0, 1, 2], [1, 2, 3]]


def _custom_collate(batch):
    xs, ys = zip(*batch)
    return np.stack(xs) * 2, np.asarray(ys)


LOADERS = {
    # (dataset class, DataLoader keywords)
    "w0": (ArrayDataset, dict(batch_size=4)),
    "w0-shuffle-drop": (ArrayDataset, dict(batch_size=5, shuffle=True,
                                           drop_last=True)),
    "w0-dict": (DictDataset, dict(batch_size=6, shuffle=True)),
    "w0-unbuffered": (ArrayDataset, dict(batch_size=4,
                                         use_buffer_reader=False)),
    "w2-processes": (ArrayDataset, dict(batch_size=4, shuffle=True,
                                        num_workers=2)),
    "w2-processes-dict": (DictDataset, dict(batch_size=5, num_workers=2)),
    "w2-threads-custom-collate": (ArrayDataset, dict(
        batch_size=4, shuffle=True, num_workers=2,
        collate_fn=_custom_collate)),
}


@pytest.mark.parametrize("name", LOADERS)
def test_dataloader_batches_match_reference(name):
    cls, kw = LOADERS[name]
    ref = rio.DataLoader(_ref_ds(cls), **kw)
    port = tio.DataLoader(_port_ds(cls), device="cpu", **kw)
    assert len(port) == len(ref)
    np.random.seed(5)
    want = [_np(b) for b in ref]
    np.random.seed(5)
    got = [_np(b) for b in port]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)


class Stream(tio.IterableDataset):
    def __iter__(self):
        for i in range(10):
            yield np.full((2,), i, np.int64)


@pytest.mark.parametrize("workers", [0, 2])
def test_iterable_dataset_batches(workers):
    loader = tio.DataLoader(Stream(), batch_size=4, num_workers=workers,
                            device="cpu")
    got = [b.tolist() for b in loader]
    assert got == [[[i, i] for i in range(j, min(j + 4, 10))]
                   for j in range(0, 10, 4)]
    with pytest.raises(TypeError):
        len(loader)


class WorkerIds(tio.Dataset):
    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.array([i, -1 if info is None else info.id])

    def __len__(self):
        return 8


def test_get_worker_info_in_worker_processes():
    assert tio.get_worker_info() is None
    loader = tio.DataLoader(WorkerIds(), batch_size=2, num_workers=2,
                            device="cpu")
    rows = torch.cat(list(loader)).tolist()
    assert [r[0] for r in rows] == list(range(8))
    assert {r[1] for r in rows} <= {0, 1} and len({r[1] for r in rows}) >= 1


def test_process_setup_failure_falls_back_to_threads(monkeypatch):
    def broken(*a, **k):
        raise OSError("no processes here")

    monkeypatch.setattr(tmp, "MultiprocessWorkerPool", broken)
    ds = _port_ds(ArrayDataset)
    want = [_np(b) for b in tio.DataLoader(ds, batch_size=4, device="cpu")]
    with pytest.warns(UserWarning, match="falling back to worker threads"):
        got = [_np(b) for b in tio.DataLoader(ds, batch_size=4,
                                              num_workers=2, device="cpu")]
    for g, w in zip(got, want):
        _assert_same(g, w)


class Failing(tio.Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad sample")
        return np.zeros(2)

    def __len__(self):
        return 8


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_error_propagates(workers):
    loader = tio.DataLoader(Failing(), batch_size=2, num_workers=workers,
                            device="cpu")
    with pytest.raises((ValueError, RuntimeError), match="bad sample|batch"):
        list(loader)


def test_dataloader_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.DataLoader(ArrayDataset())
    assert tio.DataLoader(ArrayDataset(), places="cpu").device.type == "cpu"
    assert tio.DataLoader(ArrayDataset(),
                          places=["cpu"]).device.type == "cpu"


def test_cuda_tensor_samples_refused_in_worker_processes():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meta = torch.empty(2, device="meta")
    with pytest.raises(TypeError, match="num_workers"):
        tmp._np_collate([meta, meta])
