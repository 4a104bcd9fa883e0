"""Convolutions of the PyTorch port (``paddle_tpu_torch/nn/functional/
conv.py``, ``nn/layers/conv.py``) against the reference's
``paddle_tpu.nn.functional`` on the CPU: the same numpy inputs from a
seed through both, forward and gradient (``jax.vjp`` against
``torch.autograd``), over every padding form (int, per-dim, per-side,
nested, ``"SAME"`` asymmetric at stride 2, ``"VALID"``), stride,
dilation, groups, channel-last layouts, bias, and the transposed
convolutions' ``output_padding`` / ``output_size``.

Tolerance: f32 results within 1e-5 of the largest reference magnitude
(``FWD_RTOL``); the sums run in another order on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as RF
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

FWD_RTOL = 1e-5


def close(got, want, rtol=FWD_RTOL, what=""):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


def ref_vjp(fn, arrays, seed=11):
    """The reference's output and its gradient with respect to each array
    under a random cotangent; returns (out, grads, cotangent)."""
    out, pull = jax.vjp(lambda *a: raw(fn(*a)),
                        *[jnp.asarray(a) for a in arrays])
    cot = np.random.default_rng(seed).standard_normal(out.shape) \
        .astype(np.float32)
    return np.asarray(out), [np.asarray(g) for g in pull(jnp.asarray(cot))], \
        cot


def port_vjp(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def check_parity(rfn, tfn, arrays, what):
    want, want_g, cot = ref_vjp(rfn, arrays)
    got, got_g = port_vjp(tfn, arrays, cot)
    close(got, want, what=what)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        close(g, w, what=f"{what} grad {i}")


def _arrays(x_shape, w_shape, bias, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(x_shape).astype(np.float32),
           (0.3 * rng.standard_normal(w_shape)).astype(np.float32)]
    if bias:
        out.append(rng.standard_normal(bias).astype(np.float32))
    return out


# name -> (op, x shape, weight shape, bias size or None, kwargs)
CONV_CASES = {
    "2d-basic": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), None, {}),
    "2d-pad1-s2-bias": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), 6,
                        dict(stride=2, padding=1)),
    "2d-same-s2-asym": ("conv2d", (2, 3, 10, 11), (5, 3, 3, 3), None,
                        dict(stride=2, padding="SAME")),
    "2d-same-s1-even-k": ("conv2d", (1, 3, 7, 8), (4, 3, 2, 4), 4,
                          dict(padding="same")),
    "2d-valid": ("conv2d", (2, 3, 8, 8), (4, 3, 3, 3), None,
                 dict(padding="VALID", stride=(1, 2))),
    "2d-per-dim": ("conv2d", (2, 3, 8, 9), (4, 3, 3, 3), None,
                   dict(padding=[1, 2])),
    "2d-per-side": ("conv2d", (2, 3, 8, 9), (4, 3, 3, 3), None,
                    dict(padding=[1, 0, 2, 1], stride=2)),
    "2d-dilation-groups": ("conv2d", (2, 4, 11, 10), (6, 2, 3, 3), 6,
                           dict(padding=2, dilation=2, groups=2)),
    "2d-depthwise": ("conv2d", (2, 4, 7, 7), (8, 1, 3, 3), None,
                     dict(padding=1, groups=4, stride=2)),
    "2d-nhwc-same": ("conv2d", (2, 9, 10, 3), (4, 3, 3, 3), 4,
                     dict(stride=2, padding="SAME", data_format="NHWC")),
    "1d-same-s2": ("conv1d", (2, 4, 11), (5, 4, 3), 5,
                   dict(stride=2, padding="SAME")),
    "1d-nlc-per-side": ("conv1d", (2, 11, 4), (5, 4, 3), None,
                        dict(padding=[0, 2], data_format="NLC")),
    "1d-dilation": ("conv1d", (2, 4, 13), (4, 2, 3), None,
                    dict(dilation=3, groups=2, padding=1)),
    "3d-pad-stride": ("conv3d", (1, 2, 5, 6, 7), (3, 2, 2, 3, 2), 3,
                      dict(padding=1, stride=(1, 2, 1))),
    "3d-nested": ("conv3d", (1, 2, 4, 5, 4), (2, 2, 2, 2, 3), None,
                  dict(padding=[[0, 0], [0, 0], [1, 0], [0, 2], [1, 1]])),
    "3d-ndhwc-same": ("conv3d", (1, 5, 6, 7, 2), (3, 2, 3, 3, 3), None,
                      dict(stride=2, padding="SAME", data_format="NDHWC")),
    # transposed: weight [in, out / groups, *k]
    "2dT-s2-p1-opad": ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3), 3,
                       dict(stride=2, padding=1, output_padding=1)),
    "2dT-groups-dilation": ("conv2d_transpose", (2, 4, 5, 6), (4, 2, 3, 3),
                            4, dict(stride=2, dilation=2, groups=2)),
    "2dT-same-s2": ("conv2d_transpose", (2, 3, 5, 6), (3, 2, 3, 3), None,
                    dict(stride=2, padding="SAME")),
    "2dT-per-side-opad": ("conv2d_transpose", (1, 3, 4, 5), (3, 2, 3, 3), 2,
                          dict(stride=2, padding=[0, 1, 1, 2],
                               output_padding=1)),
    "2dT-output-size": ("conv2d_transpose", (2, 3, 5, 5), (3, 2, 3, 3), 2,
                        dict(stride=2, padding=1, output_padding=1,
                             output_size=[9, 10])),
    "2dT-opad-ge-stride": ("conv2d_transpose", (1, 3, 5, 5), (3, 2, 3, 3),
                           None, dict(padding=1, output_padding=1)),
    "2dT-nhwc": ("conv2d_transpose", (2, 5, 4, 3), (3, 4, 2, 2), 4,
                 dict(stride=2, data_format="NHWC")),
    "1dT-per-side": ("conv1d_transpose", (2, 3, 7), (3, 4, 3), 4,
                     dict(stride=2, padding=[1, 0])),
    "3dT-s2": ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 3, 2, 2, 2), 3,
               dict(stride=2)),
}


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_matches_reference(case):
    op, xs, ws, bias, kw = CONV_CASES[case]
    arrays = _arrays(xs, ws, bias)
    rfn, tfn = getattr(RF, op), getattr(TF, op)
    if bias:
        check_parity(lambda x, w, b: rfn(x, w, b, **kw),
                     lambda x, w, b: tfn(x, w, b, **kw), arrays, case)
    else:
        check_parity(lambda x, w: rfn(x, w, **kw),
                     lambda x, w: tfn(x, w, **kw), arrays, case)


def test_conv2d_nested_padding_is_per_side():
    """A nested 2-D padding keeps its last two pairs. The reference reads
    a 4-element list as per-side values first and fails on the pairs
    (ROADMAP.md §C.16), so the port's nested form is held against the
    reference's per-side form of the same pads."""
    arrays = _arrays((2, 3, 8, 9), (4, 3, 3, 3), 4)
    check_parity(lambda x, w, b: RF.conv2d(x, w, b, padding=[1, 2, 0, 1]),
                 lambda x, w, b: TF.conv2d(
                     x, w, b, padding=[[0, 0], [0, 0], [1, 2], [0, 1]]),
                 arrays, "2d-nested")


# layer -> (constructor arguments, input shape, forward keyword arguments)
LAYER_CASES = {
    "Conv1D": ((3, 4, 3), dict(stride=2, padding="SAME"), (2, 3, 9)),
    "Conv2D": ((3, 6, 3), dict(padding=1, groups=3), (2, 3, 7, 7)),
    "Conv3D": ((2, 3, 2), dict(stride=2, bias_attr=False), (1, 2, 4, 5, 4)),
    "Conv1DTranspose": ((3, 4, 3), dict(stride=2), (2, 3, 5)),
    "Conv2DTranspose": ((4, 6, 3), dict(stride=2, padding=1, groups=2,
                                        output_padding=1), (2, 4, 4, 5)),
    "Conv3DTranspose": ((2, 3, 2), dict(stride=2), (1, 2, 3, 3, 2)),
}


@pytest.mark.parametrize("name", LAYER_CASES)
def test_conv_layers_match_reference(name):
    """The layers' parameter names, shapes and init scale, and their
    forward on bridged weights."""
    import paddle_tpu as paddle

    args, kw, xs = LAYER_CASES[name]
    paddle.seed(3)
    ref = getattr(rnn, name)(*args, **kw)
    port = getattr(tnn, name)(*args, **kw, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    rstate = {k: np.asarray(raw(v)) for k, v in ref.state_dict().items()}
    pstate = port.state_dict()
    assert list(pstate) == list(rstate)
    for k, v in rstate.items():
        assert tuple(pstate[k].shape) == v.shape, k
    # XavierNormal on both sides: the same std, different draws
    w = pstate["weight"].numpy()
    np.testing.assert_allclose(w.std(), rstate["weight"].std(), rtol=0.5)
    port.load_state_dict({k: torch.tensor(v) for k, v in rstate.items()})
    x = np.random.default_rng(1).standard_normal(xs).astype(np.float32)
    close(port(torch.from_numpy(x)).detach().numpy(),
          np.asarray(raw(ref(jnp.asarray(x)))), what=name)


def test_conv_refuses_padding_modes_the_reference_ignores():
    with pytest.raises(NotImplementedError, match="padding_mode"):
        tnn.Conv2D(3, 4, 3, padding=1, padding_mode="reflect", device="cpu")
    tnn.Conv2D(3, 4, 3, padding_mode="zeros", device="cpu")


def test_conv_layer_takes_param_attr():
    from paddle_tpu_torch.nn import initializer as I

    conv = tnn.Conv2D(2, 3, 1, device="cpu",
                      weight_attr=tnn.ParamAttr(initializer=I.Constant(0.5),
                                                learning_rate=0.1),
                      bias_attr=False)
    assert conv.bias is None
    assert torch.all(conv.weight == 0.5)
    assert conv.weight.optimize_attr["learning_rate"] == 0.1
