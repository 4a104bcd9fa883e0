"""The activation layers and functionals of the PyTorch port
(``paddle_tpu_torch/nn/layers/activation.py``, ``nn/functional/
activation.py``) against the reference's on the CPU.

One parametrised case per layer the port added (24), each with the
reference's constructor arguments: the layer's output and the input's
gradient under a seeded cotangent (``PReLU``'s weight gradient too), and
the functional of the same name on the same input. ``RReLU`` runs in
eval mode (the mean slope: the reference takes it in training too);
its training slopes come from the port's explicit generator and are
checked for their range and their replay. ``gumbel_softmax`` takes its
noise from torch's generator, the reference's from its key stream: the
same noise is fed to both (soft and hard, with the straight-through
gradient).

Tolerance: f32 outputs within rel 1e-5 of the largest reference
magnitude, gradients within rel 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

from torch_port_utils import one_torch_thread  # noqa: F401

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4

# (layer, functional, constructor / functional keyword arguments)
CASES = [
    ("CELU", "celu", dict(alpha=1.3)),
    ("ELU", "elu", dict(alpha=0.7)),
    ("GLU", "glu", dict(axis=1)),
    ("Hardshrink", "hardshrink", dict(threshold=0.4)),
    ("Hardsigmoid", "hardsigmoid", {}),
    ("Hardswish", "hardswish", {}),
    ("Hardtanh", "hardtanh", dict(min=-0.8, max=1.2)),
    ("LeakyReLU", "leaky_relu", dict(negative_slope=0.05)),
    ("LogSigmoid", "log_sigmoid", {}),
    ("Maxout", "maxout", dict(groups=2, axis=1)),
    ("Mish", "mish", {}),
    ("PReLU", None, dict(num_parameters=4, init=0.3)),
    ("RReLU", "rrelu", dict(lower=0.1, upper=0.3)),
    ("ReLU6", "relu6", {}),
    ("SELU", "selu", {}),
    ("SiLU", "silu", {}),
    ("Sigmoid", "sigmoid", {}),
    ("Softmax2D", None, {}),
    ("Softplus", "softplus", dict(beta=2.0, threshold=3.0)),
    ("Softshrink", "softshrink", dict(threshold=0.3)),
    ("Softsign", "softsign", {}),
    ("Swish", "swish", {}),
    ("Tanhshrink", "tanhshrink", {}),
    ("ThresholdedReLU", "thresholded_relu", dict(threshold=0.5)),
]


def close(got, want, rtol, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


def _data(shape=(2, 4, 3, 5), seed=0):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    return x, rng.standard_normal(shape).astype(np.float32)


def test_every_reference_activation_layer_is_ported():
    names = [c[0] for c in CASES]
    assert len(names) == 24
    for n in names:
        assert getattr(tnn, n) is not None and hasattr(rnn, n), n


@pytest.mark.parametrize("layer,fn,kw", CASES, ids=[c[0] for c in CASES])
def test_activation_matches_reference(layer, fn, kw):
    x, _ = _data()
    ref = getattr(rnn, layer)(**kw)
    port = getattr(tnn, layer)(**kw, **(
        dict(device="cpu") if layer == "PReLU" else {}))
    ref.eval()
    port.eval()
    rx = paddle.to_tensor(x, stop_gradient=False)
    ry = ref(rx)
    want = np.asarray(ry._value)
    px = torch.tensor(x, requires_grad=True)
    py = port(px)
    close(py.detach().numpy(), want, FWD_RTOL, f"{layer} forward")
    # the cotangent has the output's shape (GLU and Maxout halve axis 1)
    w = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    (ry * paddle.to_tensor(w)).sum().backward()
    (py * torch.from_numpy(w)).sum().backward()
    close(px.grad.numpy(), np.asarray(rx.grad._value), GRAD_RTOL,
          f"{layer} input gradient")
    if layer == "PReLU":
        close(port.weight.grad.numpy(), np.asarray(ref.weight.grad._value),
              GRAD_RTOL, "PReLU weight gradient")
    if fn is not None:
        got = getattr(TF, fn)(torch.from_numpy(x), **kw)
        ref_fn = np.asarray(getattr(RF, fn)(paddle.to_tensor(x), **kw)._value)
        close(got.numpy(), ref_fn, FWD_RTOL, f"F.{fn}")


def test_prelu_functional_channel_last_and_scalar_weight():
    x, _ = _data((2, 3, 4))
    for fmt, n in (("NCL", 3), ("NLC", 4), ("NCL", 1)):
        w = np.linspace(0.1, 0.5, n).astype(np.float32)
        want = np.asarray(RF.prelu(paddle.to_tensor(x), paddle.to_tensor(w),
                                   data_format=fmt)._value)
        got = TF.prelu(torch.from_numpy(x), torch.from_numpy(w),
                       data_format=fmt)
        close(got.numpy(), want, FWD_RTOL, f"prelu {fmt} {n}")


def test_rrelu_training_draws_slopes_from_its_generator():
    x, _ = _data()
    t = torch.from_numpy(x)
    outs = []
    for _ in range(2):
        layer = tnn.RReLU(0.1, 0.3,
                          generator=torch.Generator().manual_seed(3))
        layer.train()
        outs.append(layer(t))
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    neg = x < 0
    slope = outs[0].numpy()[neg] / x[neg]
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    assert slope.std() > 0.01          # drawn, not the mean slope
    np.testing.assert_array_equal(outs[0].numpy()[~neg], x[~neg])


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_on_fed_noise(monkeypatch, hard):
    x, w = _data((3, 7))
    noise = np.random.default_rng(2).gumbel(size=x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype: jnp.asarray(noise, dtype))
    from paddle_tpu_torch.nn.functional import activation as tact
    monkeypatch.setattr(tact, "_gumbel_noise",
                        lambda t: torch.from_numpy(noise).to(t.dtype))
    rx = paddle.to_tensor(x, stop_gradient=False)
    ry = RF.gumbel_softmax(rx, temperature=0.7, hard=hard)
    px = torch.tensor(x, requires_grad=True)
    py = TF.gumbel_softmax(px, temperature=0.7, hard=hard)
    close(py.detach().numpy(), np.asarray(ry._value), FWD_RTOL, "forward")
    (ry * paddle.to_tensor(w)).sum().backward()
    (py * torch.from_numpy(w)).sum().backward()
    close(px.grad.numpy(), np.asarray(rx.grad._value), GRAD_RTOL, "grad")


def test_in_place_relu_and_elu():
    x, _ = _data((4, 5))
    for fn, ref_fn in ((TF.relu_, RF.relu), (TF.elu_, RF.elu)):
        t = torch.from_numpy(x.copy())
        out = fn(t)
        assert out is t
        close(t.numpy(), np.asarray(ref_fn(paddle.to_tensor(x))._value),
              FWD_RTOL, fn.__name__)
