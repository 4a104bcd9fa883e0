"""Metrics of the PyTorch port (``paddle_tpu_torch/metric``) against the
reference's ``paddle_tpu.metric`` on the same numpy batches: ``Accuracy``
(top-1 and top-k, labels as ids, ``[N, 1]`` or one-hot, ties included),
``Precision``, ``Recall``, ``Auc`` and ``accuracy``, over several updates
and a reset."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import metric as rmetric
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import metric as tmetric


def _batches(seed=0, n=3, rows=17, classes=6):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        # rounded logits: ties between classes happen
        pred = np.round(rng.standard_normal((rows, classes)), 1)
        yield pred.astype(np.float32), rng.integers(0, classes, (rows,))


def _label_form(label, form, classes=6):
    if form == "ids":
        return label
    if form == "column":
        return label[:, None]
    return np.eye(classes, dtype=np.float32)[label]


@pytest.mark.parametrize("form", ["ids", "column", "one-hot"])
@pytest.mark.parametrize("topk", [(1,), (1, 3)], ids=["top1", "top1-3"])
def test_accuracy_matches_reference(topk, form):
    ref, port = rmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    assert port.name() == ref.name()
    for pred, label in _batches():
        lab = _label_form(label, form)
        want_c = ref.compute(Tensor(jnp.asarray(pred)),
                             Tensor(jnp.asarray(lab)))
        got_c = port.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        np.testing.assert_array_equal(got_c.numpy(),
                                      np.asarray(raw(want_c)))
        assert port.update(got_c) == ref.update(want_c)
    assert port.accumulate() == ref.accumulate()
    port.reset()
    assert port.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])


def _binary_batches(seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        yield (rng.random((20, 1)).astype(np.float32),
               rng.integers(0, 2, (20, 1)))


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_reference(name):
    ref, port = getattr(rmetric, name)(), getattr(tmetric, name)()
    assert port.name() == ref.name()
    for pred, label in _binary_batches():
        ref.update(Tensor(jnp.asarray(pred)), Tensor(jnp.asarray(label)))
        port.update(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_allclose(port.accumulate(), ref.accumulate(),
                               rtol=1e-12)
    assert 0.0 < port.accumulate() <= 1.0
    port.reset()
    assert port.accumulate() == 0.0


def test_auc_takes_the_positive_column():
    rng = np.random.default_rng(2)
    p = rng.random((30,)).astype(np.float32)
    two = np.stack([1 - p, p], 1)
    label = rng.integers(0, 2, (30,))
    ref, port = rmetric.Auc(), tmetric.Auc()
    ref.update(Tensor(jnp.asarray(two)), Tensor(jnp.asarray(label)))
    port.update(torch.from_numpy(two), torch.from_numpy(label))
    assert port.accumulate() == pytest.approx(ref.accumulate(), rel=1e-12)


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_function_matches_reference(k):
    pred, label = next(_batches(seed=3))
    want = float(np.asarray(raw(rmetric.accuracy(
        Tensor(jnp.asarray(pred)), Tensor(jnp.asarray(label[:, None])),
        k=k))))
    got = tmetric.accuracy(torch.from_numpy(pred),
                           torch.from_numpy(label[:, None]), k=k)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-7)


def test_metrics_read_bf16_predictions():
    pred = torch.tensor([[0.1, 0.9], [0.8, 0.2]], dtype=torch.bfloat16)
    m = tmetric.Accuracy()
    assert m.update(m.compute(pred, torch.tensor([1, 1]))) == 0.5
