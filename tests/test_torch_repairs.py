"""Arguments of the reference that the PyTorch port honours (ROADMAP
§C.18), each held against ``paddle_tpu`` on the CPU:

* ``nn.Dropout(p, axis, mode)`` and ``F.dropout(x, p, axis, training,
  mode)``: the reference's argument order, whole slices dropped along
  ``axis``, ``downscale_in_infer``. The two packages draw their masks from
  different generators, so the masks themselves are compared by their
  structure (which entries share a decision, the scale of kept values)
  and the deterministic cases (inference, ``p`` 0 and 1) value for value;
* ``F.embedding`` / ``nn.Embedding`` with ``padding_idx`` and ``sparse``:
  outputs and gradients, the padding row zeroed at init;
* ``nn.LayerNorm`` with ``weight_attr`` / ``bias_attr`` and ``nn.RMSNorm``
  with ``weight_attr`` (``ParamAttr`` initializers, ``trainable``,
  ``False``), list shapes;
* ``tensor.sum(x, axis, dtype, keepdim)``: the reference's order.

Tolerance: f32 results within 1e-6 of the largest reference magnitude;
integer results and masks exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import tensor as TT
from paddle_tpu_torch.nn import functional as TF

from test_torch_conv import close

RTOL = 1e-6
SHAPE = (4, 6, 5)


def _x(seed=0, shape=SHAPE):
    # entries away from 0, so a dropped entry is the only zero
    rng = np.random.default_rng(seed)
    return (np.sign(rng.standard_normal(shape))
            * (0.5 + rng.random(shape))).astype(np.float32)


def _ref_dropout(x, **kw):
    paddle.seed(3)
    return np.asarray(raw(RF.dropout(paddle.to_tensor(x), **kw)))


def _port_dropout(x, **kw):
    torch.manual_seed(3)
    return TF.dropout(torch.from_numpy(x), **kw).numpy()


def _structure(x, out, p, axis, mode):
    """(keep mask, whether every kept entry is x scaled as ``mode`` says,
    whether the mask is constant along the axes not in ``axis``)."""
    keep = out != 0
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    scaled = np.allclose(out[keep], x[keep] * scale, rtol=RTOL, atol=0)
    if axis is None:
        return keep, scaled, True
    axes = tuple(a for a in range(x.ndim) if a not in axis)
    const = bool((keep.all(axis=axes) | (~keep).all(axis=axes)).all())
    return keep, scaled, const


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 1, [0, 2]],
                         ids=["none", "1", "0-2"])
def test_dropout_in_training_matches_reference_structure(axis, mode):
    x = _x()
    norm = None if axis is None else tuple(np.atleast_1d(axis).tolist())
    for impl in (_ref_dropout, _port_dropout):
        out = impl(x, p=0.5, axis=axis, training=True, mode=mode)
        keep, scaled, const = _structure(x, out, 0.5, norm, mode)
        assert scaled, (impl.__name__, mode)
        assert const, (impl.__name__, axis)
        assert 0 < keep.sum() < keep.size, impl.__name__


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("training", [True, False])
def test_dropout_deterministic_cases_match_reference(training, p, mode):
    """Inference (identity, or ``x * (1 - p)`` downscaled), ``p`` 0 and
    ``p`` 1 (all dropped) give the reference's values; at ``p`` 0.3 in
    training only the shape is compared (the masks are random)."""
    x = _x(1)
    for axis in (None, 2):
        want = _ref_dropout(x, p=p, axis=axis, training=training, mode=mode)
        got = _port_dropout(x, p=p, axis=axis, training=training, mode=mode)
        assert got.shape == want.shape
        if training and p == 0.3:
            continue
        close(got, want, rtol=RTOL, what=f"axis={axis}")


def test_dropout_layer_takes_axis_positionally():
    """``nn.Dropout(p, axis, mode)``: a positional ``axis`` is the axis
    (it once landed in ``torch.nn.Dropout``'s ``inplace``)."""
    ref = rnn.Dropout(0.5, 1, "downscale_in_infer")
    port = tnn.Dropout(0.5, 1, "downscale_in_infer")
    assert (port.p, port.axis, port.mode) == (ref.p, ref.axis, ref.mode)
    x = _x(2)
    out = port(torch.from_numpy(x)).numpy()
    keep, scaled, const = _structure(x, out, 0.5, (1,), port.mode)
    assert scaled and const
    ref.eval()
    port.eval()
    close(port(torch.from_numpy(x)).numpy(),
          np.asarray(raw(ref(paddle.to_tensor(x)))), rtol=RTOL, what="eval")
    with pytest.raises(ValueError, match="mode"):
        TF.dropout(torch.from_numpy(x), 0.5, mode="bogus")


def _embedding_pair(padding_idx, sparse=False):
    paddle.seed(0)
    ref = rnn.Embedding(11, 4, padding_idx, sparse)
    port = tnn.Embedding(11, 4, padding_idx, sparse, device="cpu")
    return ref, port


@pytest.mark.parametrize("padding_idx", [None, 0, 3, -1])
def test_embedding_padding_idx_matches_reference(padding_idx):
    """The padding row is zeroed at init (a negative index counts from
    the end, as the reference's ``.at[]`` does), then the reference's
    weights are bridged with the padding row set non-zero: the outputs at
    the padding id are still masked, and no gradient reaches that row."""
    ref, port = _embedding_pair(padding_idx, sparse=True)
    w0 = port.weight.detach().numpy()
    if padding_idx is not None:
        np.testing.assert_array_equal(w0[padding_idx], 0.0)
        np.testing.assert_array_equal(
            np.asarray(raw(ref.weight))[padding_idx], 0.0)
    w = np.random.default_rng(1).standard_normal((11, 4)).astype(np.float32)
    ids = np.array([[0, 3, 5, 3], [10, 0, 1, 2]])
    want = np.asarray(raw(RF.embedding(paddle.to_tensor(ids),
                                       paddle.to_tensor(w), padding_idx)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = TF.embedding(torch.from_numpy(ids), wt, padding_idx, True)
    close(got.detach().numpy(), want, rtol=RTOL, what="F.embedding")
    got.sum().backward()
    counts = np.zeros(11, np.float32)
    np.add.at(counts, ids.reshape(-1), 1.0)
    if padding_idx is not None and padding_idx >= 0:
        counts[padding_idx] = 0.0
    np.testing.assert_array_equal(wt.grad.numpy(),
                                  np.repeat(counts[:, None], 4, 1))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
    ref.weight._rebind(jnp.asarray(w))
    close(port(torch.from_numpy(ids)).detach().numpy(),
          np.asarray(raw(ref(paddle.to_tensor(ids)))), rtol=RTOL,
          what="nn.Embedding")


def _attr(pkg, value, trainable=True):
    return pkg.ParamAttr(initializer=pkg.initializer.Constant(value),
                         trainable=trainable)


def _ln_attrs(pkg, case):
    """``LayerNorm`` keyword arguments of package ``pkg`` for ``case``."""
    return {"default": {},
            "const": dict(weight_attr=_attr(pkg, 1.5),
                          bias_attr=_attr(pkg, 0.25)),
            "frozen": dict(weight_attr=_attr(pkg, 1.5, trainable=False)),
            "no-bias": dict(bias_attr=False),
            "none": dict(weight_attr=False, bias_attr=False)}[case]


@pytest.mark.parametrize("case", ["default", "const", "frozen", "no-bias",
                                  "none"])
@pytest.mark.parametrize("shape", [8, [2, 8]], ids=["int", "list"])
def test_layer_norm_attrs_match_reference(shape, case):
    x = _x(4, (3, 2, 8))
    ref = rnn.LayerNorm(shape, 1e-5, **_ln_attrs(rnn, case))
    port = tnn.LayerNorm(shape, 1e-5, device="cpu", **_ln_attrs(tnn, case))
    for name in ("weight", "bias"):
        r, t = getattr(ref, name), getattr(port, name)
        assert (r is None) == (t is None), name
        if t is not None:
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(raw(r)))
            assert t.requires_grad == (not r.stop_gradient), name
    close(port(torch.from_numpy(x)).detach().numpy(),
          np.asarray(raw(ref(paddle.to_tensor(x)))), rtol=RTOL, what=case)


@pytest.mark.parametrize("case", ["default", "const", "frozen"])
def test_rms_norm_weight_attr_matches_reference(case):
    x = _x(5, (3, 8))
    attrs = {"default": (None, None),
             "const": (_attr(rnn, 0.75), _attr(tnn, 0.75)),
             "frozen": (_attr(rnn, 0.75, False), _attr(tnn, 0.75, False))}
    rattr, tattr = attrs[case]
    ref = rnn.RMSNorm(8, 1e-6, rattr)
    port = tnn.RMSNorm(8, 1e-6, tattr, device="cpu")
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  np.asarray(raw(ref.weight)))
    assert port.weight.requires_grad == (not ref.weight.stop_gradient)
    close(port(torch.from_numpy(x)).detach().numpy(),
          np.asarray(raw(ref(paddle.to_tensor(x)))), rtol=RTOL, what=case)


@pytest.mark.parametrize("args", [
    (None,), (1,), (1, None, True), ((0, 2), "float32"),
    (0, "int32", True), (None, None, False)],
    ids=["all", "axis", "keepdim", "dtype-f32", "dtype-i32-keepdim", "pos"])
@pytest.mark.parametrize("kind", ["float", "int", "bool"])
def test_sum_takes_dtype_third_as_reference(kind, args):
    """``sum(x, axis, dtype, keepdim)`` positionally: dtype, shape and
    values equal the reference's. Without a dtype a bool input sums to
    int64 on both sides; JAX, its 64-bit types off, narrows the
    reference's to int32."""
    rng = np.random.default_rng(6)
    x = {"float": rng.standard_normal(SHAPE).astype(np.float32),
         "int": rng.integers(-5, 5, SHAPE).astype(np.int32),
         "bool": rng.random(SHAPE) > 0.5}[kind]
    want = np.asarray(raw(paddle.sum(paddle.to_tensor(x), *args)))
    got = TT.sum(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape
    if kind == "bool" and (len(args) < 2 or args[1] is None):
        assert (got.dtype, want.dtype) == (np.int64, np.int32)
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    close(got.astype(np.float64), want.astype(np.float64), rtol=RTOL,
          what=str(args))
