"""Pooling of the PyTorch port (``paddle_tpu_torch/nn/functional/conv.py``
pools, ``nn/layers/pooling.py``) against the reference's
``paddle_tpu.nn.functional`` on the CPU, forward and gradient
(``jax.vjp`` against ``torch.autograd``): max and average pools in 1-D,
2-D and 3-D over every padding form, ``ceil_mode`` (the reference's right
extra, which torch's own ceil mode does not add), ``exclusive`` both ways,
pads wider than half the window (the explicit-padding route), channel-last
layouts and ``return_mask``'s flat indices; the adaptive pools over
divisible and non-divisible sizes. Every window holds a real cell (one
wholly in the padding is -inf or 0 / 0 on both sides).

Tolerance: f32 within 1e-5 of the largest reference magnitude; masks
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as RF
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

from test_torch_conv import check_parity, close

X2 = (2, 3, 9, 10)

# name -> (op, input shape, keyword arguments)
POOL_CASES = {
    "max2d-k3s2p1": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                            padding=1)),
    "max2d-ceil": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                          ceil_mode=True)),
    "max2d-ceil-pad": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                              padding=1, ceil_mode=True)),
    "max2d-wide-pad": ("max_pool2d", X2, dict(kernel_size=3, stride=1,
                                              padding=2)),
    "max2d-same": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                          padding="SAME")),
    "max2d-per-side": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                              padding=[0, 1, 1, 0])),
    "max2d-rect": ("max_pool2d", X2, dict(kernel_size=(2, 3),
                                          stride=(1, 2))),
    "max2d-nhwc": ("max_pool2d", (2, 9, 10, 3), dict(
        kernel_size=3, stride=2, padding=1, ceil_mode=True,
        data_format="NHWC")),
    "max1d-ceil": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                                  padding=1,
                                                  ceil_mode=True)),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                                  ceil_mode=True)),
    "max3d-ndhwc": ("max_pool3d", (1, 5, 6, 7, 2), dict(
        kernel_size=3, stride=2, padding=1, data_format="NDHWC")),
    "avg2d-k3s2p1": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                            padding=1)),
    "avg2d-k3s2p1-incl": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                                 padding=1,
                                                 exclusive=False)),
    "avg2d-ceil": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                          ceil_mode=True)),
    "avg2d-ceil-incl": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                               padding=1, ceil_mode=True,
                                               exclusive=False)),
    "avg2d-wide-pad": ("avg_pool2d", X2, dict(kernel_size=3, stride=1,
                                              padding=[2, 1])),
    "avg2d-same": ("avg_pool2d", X2, dict(kernel_size=2, stride=2,
                                          padding="SAME")),
    "avg2d-nhwc": ("avg_pool2d", (2, 9, 10, 3), dict(
        kernel_size=3, stride=2, padding=[1, 0, 0, 1],
        data_format="NHWC")),
    "avg1d-ceil": ("avg_pool1d", (2, 3, 11), dict(kernel_size=4, stride=3,
                                                  padding=1,
                                                  ceil_mode=True)),
    "avg1d-incl": ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                                  padding=1,
                                                  exclusive=False)),
    "avg3d-ceil": ("avg_pool3d", (1, 2, 5, 6, 7), dict(
        kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "avg3d-incl": ("avg_pool3d", (1, 2, 5, 6, 7), dict(
        kernel_size=3, stride=2, padding=1, exclusive=False)),
    "adaptive-avg1d": ("adaptive_avg_pool1d", (2, 3, 11),
                       dict(output_size=4)),
    "adaptive-avg2d": ("adaptive_avg_pool2d", X2,
                       dict(output_size=(4, 3))),
    "adaptive-avg2d-divisible": ("adaptive_avg_pool2d", (2, 3, 8, 6),
                                 dict(output_size=(4, 1))),
    "adaptive-avg2d-nhwc": ("adaptive_avg_pool2d", (2, 9, 10, 3),
                            dict(output_size=4, data_format="NHWC")),
    "adaptive-avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 6, 7),
                       dict(output_size=(2, 4, 3))),
    "adaptive-max1d": ("adaptive_max_pool1d", (2, 3, 11),
                       dict(output_size=5)),
    "adaptive-max2d": ("adaptive_max_pool2d", X2,
                       dict(output_size=(3, 4))),
    "adaptive-max3d": ("adaptive_max_pool3d", (1, 2, 5, 6, 7),
                       dict(output_size=(3, 2, 4))),
}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_matches_reference(case):
    op, shape, kw = POOL_CASES[case]
    rfn, tfn = getattr(RF, op), getattr(TF, op)
    check_parity(lambda x: rfn(x, **kw), lambda x: tfn(x, **kw),
                 [_x(shape)], case)


# name -> (op, input shape, kernel, stride, padding)
MASK_CASES = {
    "1d": ("max_pool1d", (2, 3, 11), 3, 2, 1),
    "2d-k3s2p1": ("max_pool2d", X2, 3, 2, 1),
    "2d-k2s2": ("max_pool2d", X2, 2, None, 0),
    "2d-wide-pad": ("max_pool2d", X2, 3, 1, 2),
    "3d": ("max_pool3d", (1, 2, 5, 6, 7), 3, 2, 1),
}


@pytest.mark.parametrize("case", MASK_CASES)
def test_return_mask_matches_reference(case):
    """The pooled values and each window's argmax as a flat index into the
    unpadded spatial dims (the reference's unpool indices)."""
    op, shape, k, s, p = MASK_CASES[case]
    x = _x(shape, 1)
    rout, ridx = getattr(RF, op)(jnp.asarray(x), k, s, p, return_mask=True)
    tout, tidx = getattr(TF, op)(torch.from_numpy(x), k, s, p,
                                 return_mask=True)
    close(tout.numpy(), np.asarray(raw(rout)), what=case)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(raw(ridx)))


def test_return_mask_refusals_match_reference():
    x = torch.zeros(1, 1, 4, 4)
    for kw in (dict(ceil_mode=True), dict(padding="SAME")):
        with pytest.raises(NotImplementedError):
            TF.max_pool2d(x, 2, return_mask=True, **kw)
    with pytest.raises(NotImplementedError):
        TF.max_pool2d(x.movedim(1, -1), 2, return_mask=True,
                      data_format="NHWC")


def test_refuses_arguments_the_reference_ignores():
    """``divisor_override`` (§C.14), the adaptive max pools' and the
    max-pool layers' ``return_mask`` and ``adaptive_avg_pool3d``'s NDHWC
    (§C.16): the reference accepts each and drops it."""
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="divisor_override"):
        TF.avg_pool2d(x, 2, divisor_override=3)
    with pytest.raises(NotImplementedError, match="divisor_override"):
        tnn.AvgPool3D(2, divisor_override=1)(torch.zeros(1, 1, 2, 2, 2))
    with pytest.raises(NotImplementedError, match="return_mask"):
        TF.adaptive_max_pool2d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="return_mask"):
        tnn.MaxPool2D(2, return_mask=True)
    with pytest.raises(NotImplementedError, match="NCDHW"):
        TF.adaptive_avg_pool3d(torch.zeros(1, 2, 2, 2, 1), 1,
                               data_format="NDHWC")
    TF.avg_pool2d(x, 2, divisor_override=None)


# layer -> (constructor arguments, input shape)
LAYER_CASES = {
    "MaxPool1D": ((3, 2, 1), dict(ceil_mode=True), (2, 3, 10)),
    "MaxPool2D": ((3, 2, 1), {}, X2),
    "MaxPool3D": ((2,), dict(ceil_mode=True), (1, 2, 5, 4, 3)),
    "AvgPool1D": ((3, 2, 1), dict(exclusive=False), (2, 3, 10)),
    "AvgPool2D": ((3, 2, 1), dict(ceil_mode=True), X2),
    "AvgPool3D": ((2, 2, 1), {}, (1, 2, 5, 4, 3)),
    "AdaptiveAvgPool1D": ((3,), {}, (2, 3, 10)),
    "AdaptiveAvgPool2D": (((1, 1),), {}, X2),
    "AdaptiveAvgPool3D": ((2,), {}, (1, 2, 5, 4, 3)),
    "AdaptiveMaxPool1D": ((3,), {}, (2, 3, 10)),
    "AdaptiveMaxPool2D": ((2,), {}, X2),
    "AdaptiveMaxPool3D": (((1, 2, 3),), {}, (1, 2, 5, 4, 3)),
}


@pytest.mark.parametrize("name", LAYER_CASES)
def test_pool_layers_match_reference(name):
    args, kw, shape = LAYER_CASES[name]
    x = _x(shape, 2)
    want = raw(getattr(rnn, name)(*args, **kw)(jnp.asarray(x)))
    got = getattr(tnn, name)(*args, **kw)(torch.from_numpy(x))
    close(got.numpy(), np.asarray(want), what=name)
