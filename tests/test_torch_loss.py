"""Losses of the PyTorch port (``paddle_tpu_torch/nn/functional/loss.py``,
``nn/layers/loss.py``) against the reference's on the same numpy inputs:
``cross_entropy`` with hard and soft labels, ``ignore_index``, ``weight``,
``axis``, ``label_smoothing``, ``use_softmax=False`` and each reduction,
its gradient, ``softmax_with_cross_entropy``, ``nll_loss``,
``CrossEntropyLoss`` and ``F.tanh``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.nn.functional as RF
from paddle_tpu import nn as rnn
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

# f32 log-softmax and means in other orders
TOL = 1e-6

C = 5


def _inputs(seed=0, axis=-1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 3, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, (4, 3))
    labels[1, 2] = labels[3, 0] = -100
    soft = rng.random((4, 3, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = rng.random(C).astype(np.float32) + 0.5
    if axis == 1:
        x = np.ascontiguousarray(np.moveaxis(x, -1, 1))
        soft = np.ascontiguousarray(np.moveaxis(soft, -1, 1))
    return x, labels, soft, weight


def _both(fn_ref, fn_port, *arrays, **kw):
    want = np.asarray(raw(fn_ref(*(None if a is None else
                                   Tensor(jnp.asarray(a)) for a in arrays),
                                 **kw)))
    got = fn_port(*(None if a is None else torch.from_numpy(a)
                    for a in arrays), **kw)
    return got.detach().numpy(), want


CASES = {
    "hard": dict(),
    "hard-sum": dict(reduction="sum"),
    "hard-none": dict(reduction="none"),
    "hard-smooth": dict(label_smoothing=0.1),
    "hard-weight": dict(weight=True),
    "hard-weight-none": dict(weight=True, reduction="none"),
    "hard-axis1": dict(axis=1),
    "hard-trailing-1": dict(trailing=True),
    "hard-ignore-0": dict(ignore_index=0),
    "soft": dict(soft_label=True),
    "soft-smooth": dict(soft_label=True, label_smoothing=0.2),
    "soft-none": dict(soft_label=True, reduction="none"),
    "probs": dict(use_softmax=False),
    "probs-weight-sum": dict(use_softmax=False, weight=True,
                             reduction="sum"),
}


@pytest.mark.parametrize("case", CASES)
def test_cross_entropy_matches_reference(case):
    kw = dict(CASES[case])
    axis = kw.get("axis", -1)
    x, labels, soft, weight = _inputs(axis=axis)
    w = weight if kw.pop("weight", False) else None
    if kw.pop("trailing", False):
        labels = labels[..., None]
    if kw.get("ignore_index") == 0:
        labels = np.where(labels < 0, 0, labels)
    label = soft if kw.get("soft_label") else labels
    if not kw.get("use_softmax", True):
        e = np.exp(x - x.max(axis, keepdims=True))
        x = (e / e.sum(axis, keepdims=True)).astype(np.float32)
    got, want = _both(RF.cross_entropy, TF.cross_entropy, x, label, w, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["hard", "hard-weight", "soft-smooth"])
def test_cross_entropy_grad_matches_reference(case):
    kw = dict(CASES[case])
    x, labels, soft, weight = _inputs(seed=1)
    w = weight if kw.pop("weight", False) else None
    label = soft if kw.get("soft_label") else labels
    xr = Tensor(jnp.asarray(x), stop_gradient=False)
    RF.cross_entropy(xr, Tensor(jnp.asarray(label)),
                     None if w is None else Tensor(jnp.asarray(w)),
                     **kw).backward()
    xt = torch.from_numpy(x).requires_grad_()
    TF.cross_entropy(xt, torch.from_numpy(label),
                     None if w is None else torch.from_numpy(w),
                     **kw).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(raw(xr.grad)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy_matches_reference(return_softmax):
    x, labels, _, _ = _inputs(seed=2)
    lab = labels[..., None]
    want = RF.softmax_with_cross_entropy(
        Tensor(jnp.asarray(x)), Tensor(jnp.asarray(lab)),
        return_softmax=return_softmax)
    got = TF.softmax_with_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(lab),
        return_softmax=return_softmax)
    want = want if return_softmax else (want,)
    got = got if return_softmax else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(raw(w)), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_nll_loss_matches_reference(reduction, weighted):
    rng = np.random.default_rng(3)
    logp = np.log(rng.dirichlet(np.ones(C), (6, 2))).astype(np.float32)
    logp = np.ascontiguousarray(np.moveaxis(logp, -1, 1))  # [N, C, 2]
    labels = rng.integers(0, C, (6, 2))
    labels[0, 1] = -100
    w = rng.random(C).astype(np.float32) if weighted else None
    got, want = _both(RF.nll_loss, TF.nll_loss, logp, labels, w,
                      reduction=reduction)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cross_entropy_layer_matches_reference():
    x, labels, _, weight = _inputs(seed=4)
    kw = dict(ignore_index=-100, label_smoothing=0.05)
    want = rnn.CrossEntropyLoss(weight=Tensor(jnp.asarray(weight)), **kw)(
        Tensor(jnp.asarray(x)), Tensor(jnp.asarray(labels)))
    got = tnn.CrossEntropyLoss(weight=torch.from_numpy(weight), **kw)(
        torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(np.asarray(raw(want))),
                               rtol=TOL)


def test_tanh_matches_reference():
    x = np.linspace(-4, 4, 17, dtype=np.float32)
    got, want = _both(RF.tanh, TF.tanh, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
