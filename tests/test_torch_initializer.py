"""The initializers of the PyTorch port (``paddle_tpu_torch/nn/
initializer.py``) against the reference's on the CPU.

The deterministic ones (``Constant``, ``Assign``, ``Dirac``, ``Bilinear``,
``calculate_gain``, the fans through the Xavier / Kaiming bounds) equal
the reference's exactly. The random ones draw from a different generator
(torch's, the reference's a JAX key), so they are held by their
statistics over 40 000 draws: every value inside the bound, mean and std
within 0.02 absolute of the reference's sample (and of the formula) —
about four standard errors of the std estimate at these sizes; and
``Orthogonal``'s ``W W^T`` (the shorter side) equal to ``gain^2 I`` within
1e-5, as the reference's.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as RI
from paddle_tpu_torch.nn import initializer as PI

SEED = 0
BIG = (200, 200)
STAT_TOL = 0.02


def _port(init, shape):
    g = torch.Generator().manual_seed(SEED)
    return init(shape, device="cpu", generator=g).numpy()


def _ref(init, shape):
    paddle.seed(SEED)
    return np.asarray(init(shape))


@pytest.mark.parametrize("case", [
    ("Constant", (0.25,), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), (3, 4)),
    ("Dirac", (), (4, 2, 3, 3)),
    ("Dirac", (2,), (6, 3, 3)),
    ("Dirac", (), (2, 4, 1, 5)),
    ("Bilinear", (), (2, 2, 4, 4)),
    ("Bilinear", (), (3, 1, 3, 5)),
], ids=lambda c: f"{c[0]}{c[2]}")
def test_deterministic_initializers_equal_reference(case):
    name, args, shape = case
    np.testing.assert_array_equal(_port(getattr(PI, name)(*args), shape),
                                  _ref(getattr(RI, name)(*args), shape))


def test_assign_takes_tensors_and_checks_the_shape():
    v = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(
        _port(PI.Assign(torch.from_numpy(v)), (2, 3)), v)
    with pytest.raises(ValueError):
        PI.Assign(v)((3, 2), device="cpu")


@pytest.mark.parametrize("nonlinearity, param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.2),
    ("selu", None)])
def test_calculate_gain_equals_reference(nonlinearity, param):
    assert PI.calculate_gain(nonlinearity, param) == \
        RI.calculate_gain(nonlinearity, param)


def test_set_global_initializer_records_only():
    """Two module globals, read by nothing (the reference's gap, kept)."""
    w, b = PI.Normal(), PI.Constant(1.0)
    try:
        PI.set_global_initializer(w, b)
        assert (PI._global_weight_init, PI._global_bias_init) == (w, b)
        import paddle_tpu_torch.nn as tnn

        torch.manual_seed(0)
        lin = tnn.Linear(4, 3, device="cpu")
        assert torch.count_nonzero(lin.bias) == 0  # the bias stays zeros
    finally:
        PI.set_global_initializer(None, None)


# (class, args, shape, bound or None, the formula's std or None)
RANDOM = {
    "uniform": ("Uniform", (-0.3, 0.7), BIG, (-0.3, 0.7), 1 / math.sqrt(12)),
    "truncated": ("TruncatedNormal", (0.5, 2.0, -1.5, 1.0), BIG,
                  (0.5 - 3.0, 0.5 + 2.0), None),
    "kaiming-uniform": ("KaimingUniform", (), (400, 100),
                        (-math.sqrt(6 / 400), math.sqrt(6 / 400)),
                        math.sqrt(2 / 400)),
    "kaiming-normal-conv": ("KaimingNormal", (None, 0.1), (64, 16, 5, 5),
                            None, math.sqrt(2 / 1.01 / 400)),
    "kaiming-normal-fan": ("KaimingNormal", (50,), BIG, None,
                           math.sqrt(2 / 50)),
    "xavier-uniform": ("XavierUniform", (), (300, 100),
                       (-math.sqrt(6 / 400), math.sqrt(6 / 400)),
                       math.sqrt(2 / 400)),
    "normal": ("Normal", (1.0, 0.5), BIG, None, 0.5),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_initializers_statistics(case):
    name, args, shape, bound, std = RANDOM[case]
    port = _port(getattr(PI, name)(*args), shape)
    ref = _ref(getattr(RI, name)(*args), shape)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    if bound is not None:
        lo, hi = bound
        assert port.min() >= lo - 1e-6 and port.max() <= hi + 1e-6
        assert ref.min() >= lo - 1e-6 and ref.max() <= hi + 1e-6
    assert abs(port.mean() - ref.mean()) < STAT_TOL
    assert abs(port.std() - ref.std()) < STAT_TOL
    if std is not None:
        assert abs(port.std() - std) < STAT_TOL * max(std, 1.0)


@pytest.mark.parametrize("shape, gain", [((64, 16), 1.0), ((16, 64), 2.0),
                                         ((8, 4, 3, 12), 0.5)])
def test_orthogonal_rows_or_columns_orthonormal(shape, gain):
    port = _port(PI.Orthogonal(gain), shape)
    ref = _ref(RI.Orthogonal(gain), shape)
    for w in (port, ref):
        m = w.reshape(-1, shape[-1])
        gram = m @ m.T if m.shape[0] < m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(len(gram)),
                                   atol=1e-5)


def test_random_draws_follow_the_generator_and_device():
    """One seed, one draw; the draw lands on the device asked for, in the
    dtype asked for."""
    init = PI.KaimingUniform()
    a = _port(init, (8, 8))
    np.testing.assert_array_equal(a, _port(init, (8, 8)))
    w = PI.Orthogonal()((6, 4), device="cpu", dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"


def test_public_names_match_reference():
    ref = {n for n, v in vars(RI).items() if not n.startswith("_")
           and getattr(v, "__module__", None) == RI.__name__}
    assert ref and ref <= set(PI.__all__)
