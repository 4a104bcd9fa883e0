"""Batch norm of the PyTorch port (``paddle_tpu_torch/nn/functional/
norm.py::batch_norm``, ``nn/layers/norm.py``) against the reference's on
the CPU: outputs and gradients in training (the batch's statistics) and
inference (the running ones), the running ``_mean`` / ``_variance``
after 3 updates (Paddle's momentum 0.9 on the running value, the
unbiased variance), ``use_global_stats``, 1-D (``[N, C]`` and
``[N, C, L]``), 2-D in NCHW and NHWC, 3-D; ``SyncBatchNorm`` and its
``convert_sync_batchnorm``.

Tolerance: f32 within 1e-5 of the largest reference magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu.nn.functional import norm as rnorm
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

from test_torch_conv import check_parity, close

# name -> (layer, input shape, data_format or None)
CASES = {
    "1d-nc": ("BatchNorm1D", (6, 4), None),
    "1d-ncl": ("BatchNorm1D", (3, 4, 5), None),
    "2d": ("BatchNorm2D", (3, 4, 5, 6), None),
    "2d-nhwc": ("BatchNorm2D", (3, 5, 6, 4), "NHWC"),
    "3d": ("BatchNorm3D", (2, 4, 3, 4, 5), None),
    "plain": ("BatchNorm", (3, 4, 5, 6), None),
}


def _inputs(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(1.5 * rng.standard_normal(shape) + 0.7 * i).astype(np.float32)
            for i in range(n)]


def _pair(name, data_format, **kw):
    """The reference layer and the port's, with the same random affine
    parameters."""
    if data_format:
        kw["data_format"] = data_format
    ref = getattr(rnn, name)(4, **kw)
    port = getattr(tnn, name)(4, device="cpu", **kw)
    rng = np.random.default_rng(5)
    w = (1 + 0.3 * rng.standard_normal(4)).astype(np.float32)
    b = (0.2 * rng.standard_normal(4)).astype(np.float32)
    ref.weight._rebind(jnp.asarray(w))
    ref.bias._rebind(jnp.asarray(b))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
        port.bias.copy_(torch.from_numpy(b))
    return ref, port


def _stats(layer, port=False):
    if port:
        return layer._mean.numpy(), layer._variance.numpy()
    return np.asarray(raw(layer._mean)), np.asarray(raw(layer._variance))


@pytest.mark.parametrize("case", CASES)
def test_training_updates_match_reference(case):
    """Three training forwards: each output, then the running statistics,
    then an eval forward on them."""
    name, shape, df = CASES[case]
    ref, port = _pair(name, df)
    assert list(port.state_dict()) == ["weight", "bias", "_mean",
                                       "_variance"]
    for i, x in enumerate(_inputs(shape, 3)):
        want = raw(ref(jnp.asarray(x)))
        got = port(torch.from_numpy(x))
        close(got.detach().numpy(), np.asarray(want), what=f"step {i}")
    for g, w, what in zip(_stats(port, True), _stats(ref),
                          ("_mean", "_variance")):
        close(g, w, what=what)
    assert not np.allclose(_stats(port, True)[0], 0.0)
    ref.eval()
    port.eval()
    x = _inputs(shape, 1, seed=9)[0]
    close(port(torch.from_numpy(x)).detach().numpy(),
          np.asarray(raw(ref(jnp.asarray(x)))), what="eval")


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("case", ["1d-ncl", "2d", "2d-nhwc", "3d"])
def test_gradients_match_reference(case, training):
    """Gradients with respect to the input, the weight and the bias: in
    training through the batch's statistics (the reference's
    ``batch_norm_train``), in inference through the running ones."""
    name, shape, df = CASES[case]
    df = df or {3: "NCL", 4: "NCHW", 5: "NCDHW"}[len(shape)]
    rng = np.random.default_rng(2)
    x = _inputs(shape, 1)[0]
    w, b = (1 + 0.3 * rng.standard_normal((2, 4))).astype(np.float32)
    mean = rng.standard_normal(4).astype(np.float32)
    var = (1 + rng.random(4)).astype(np.float32)
    if training:
        rfn = lambda x, w, b: rnorm._bn_train(  # noqa: E731
            x, w, b, epsilon=1e-5, data_format=df)[0]
        tfn = lambda x, w, b: TF.batch_norm(  # noqa: E731
            x, torch.from_numpy(mean.copy()), torch.from_numpy(var.copy()),
            w, b, training=True, data_format=df)
    else:
        rfn = lambda x, w, b: rnorm.batch_norm(  # noqa: E731
            x, jnp.asarray(mean), jnp.asarray(var), w, b, data_format=df)
        tfn = lambda x, w, b: TF.batch_norm(  # noqa: E731
            x, torch.from_numpy(mean), torch.from_numpy(var), w, b,
            data_format=df)
    check_parity(rfn, tfn, [x, w, b], f"{case} training={training}")


def test_use_global_stats_normalises_by_running_stats_in_training():
    ref, port = _pair("BatchNorm2D", None, use_global_stats=True)
    x = _inputs((3, 4, 5, 6), 2)
    ref(jnp.asarray(x[0]))
    port(torch.from_numpy(x[0]))
    for g, w in zip(_stats(port, True), _stats(ref)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(_stats(port, True)[0], np.zeros(4))
    np.testing.assert_array_equal(_stats(port, True)[1], np.ones(4))
    assert port.training
    close(port(torch.from_numpy(x[1])).detach().numpy(),
          np.asarray(raw(ref(jnp.asarray(x[1])))), what="global stats")


def test_momentum_and_epsilon_are_paddles():
    """``momentum`` weighs the running value: one step from (0, 1) at
    momentum 0.8 leaves ``0.2 * batch`` in ``_mean``."""
    port = tnn.BatchNorm1D(3, momentum=0.8, epsilon=1e-3, device="cpu")
    x = torch.tensor([[1.0, 2.0, 3.0], [3.0, 6.0, 9.0]])
    out = port(x)
    torch.testing.assert_close(port._mean, 0.2 * x.mean(0))
    torch.testing.assert_close(port._variance,
                               0.8 + 0.2 * x.var(0, unbiased=True))
    want = (x - x.mean(0)) / torch.sqrt(x.var(0, unbiased=False) + 1e-3)
    torch.testing.assert_close(out, want)


def test_sync_batchnorm_converts_and_matches_batchnorm():
    paddle.seed(0)
    net = tnn.Sequential(tnn.Conv2D(3, 4, 1, device="cpu"),
                         tnn.BatchNorm2D(4, device="cpu"),
                         tnn.Sequential(tnn.BatchNorm2D(4, device="cpu")))
    x = torch.from_numpy(_inputs((2, 3, 4, 4), 1)[0])
    net(x)
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    assert isinstance(conv[2][0], tnn.SyncBatchNorm)
    assert list(conv.state_dict()) == list(net.state_dict())
    ref = tnn.BatchNorm2D(4, device="cpu")
    ref.load_state_dict(conv[1].state_dict())
    y = torch.randn(2, 4, 3, 3)
    torch.testing.assert_close(conv[1](y), ref(y))


@pytest.mark.parametrize("shape", [(1, 4), (1, 4, 1)], ids=["nc", "ncl"])
def test_training_on_one_value_per_channel_matches_reference(shape):
    """ROADMAP §C.17: ``BatchNorm1D(4)`` trained on one value per channel.
    torch's ``batch_norm`` refuses it; the reference normalises by the
    biased variance (0, so the output is the bias) and unbiases the
    running term by ``n / max(n - 1, 1)``. Outputs of three steps, both
    running buffers, then an eval forward on them; and the gradients."""
    ref, port = _pair("BatchNorm1D", None)
    for i, x in enumerate(_inputs(shape, 3)):
        want = raw(ref(jnp.asarray(x)))
        got = port(torch.from_numpy(x))
        close(got.detach().numpy(), np.asarray(want), what=f"step {i}")
    for g, w, what in zip(_stats(port, True), _stats(ref),
                          ("_mean", "_variance")):
        close(g, w, what=what)
    assert not np.allclose(_stats(port, True)[0], 0.0)
    ref.eval()
    port.eval()
    x = _inputs(shape, 1, seed=9)[0]
    close(port(torch.from_numpy(x)).detach().numpy(),
          np.asarray(raw(ref(jnp.asarray(x)))), what="eval")
    rng = np.random.default_rng(2)
    w, b = (1 + 0.3 * rng.standard_normal((2, 4))).astype(np.float32)
    rfn = lambda x, w, b: rnorm._bn_train(  # noqa: E731
        x, w, b, epsilon=1e-5, data_format="NCL")[0]
    tfn = lambda x, w, b: TF.batch_norm(  # noqa: E731
        x, torch.zeros(4), torch.ones(4), w, b, training=True)
    check_parity(rfn, tfn, [x, w, b], "one value per channel")
