"""The tensor API of the PyTorch port against ``paddle_tpu``'s on the CPU:
one case per ported function (more for the functions whose Paddle
semantics differ from torch's same-named call). Each case makes its
inputs with a seeded numpy ``RandomState`` and runs them through
``paddle_tpu.<name>`` and ``paddle_tpu_torch.<name>``.

Tolerances: float32 ``rtol=1e-5, atol=1e-6``; the special functions
``rtol=1e-4``; integer and bool results exactly. Dtypes must be equal, up
to the int64 the port keeps where the reference, its 64-bit types off,
narrows to int32 (ROADMAP §C.19). Random functions are held to shape,
dtype, range or moments and repeatability under ``paddle.seed``; their
values are not compared (threefry and Philox streams differ).
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.tensor
import paddle_tpu_torch as T
import paddle_tpu_torch.tensor
from paddle_tpu.framework.core import Tensor as RefTensor
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import device as tdevice
from tensor_api_cases import (CASES, RANDOM, RANDOM_LIKE, SPECIAL, case_rng,
                              port_arg)

#: public names of ``paddle_tpu.tensor`` the port does not have yet, each
#: named in ROADMAP A.9b with its reason
DEFERRED = {
    # linalg decompositions and solvers (A.9b)
    "cholesky", "cholesky_solve", "cond", "det", "eig", "eigh", "eigvals",
    "eigvalsh", "householder_product", "inv", "inverse", "lstsq",
    "lstsq_op", "lu", "lu_op", "lu_unpack", "matrix_exp", "matrix_rank",
    "matrix_rank_op", "ormqr", "pca_lowrank", "pca_lowrank_helper", "pinv",
    "pinverse", "qr", "slogdet", "solve", "solve_triangular", "svd",
    "svd_lowrank", "svdvals", "triangular_solve",
    # the reference's JAX gateway and tensor class (the Tensor-method
    # design item of A.9b)
    "Tensor", "defop", "raw", "is_tracer_value",
}


def _ref_arg(a):
    if isinstance(a, (np.ndarray, np.floating)):
        return P.to_tensor(np.asarray(a))
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_ref_arg(v) for v in a]
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return tuple(_ref_arg(v) for v in a)
    return a


def _np(v):
    if isinstance(v, RefTensor):
        return np.asarray(raw(v))
    if isinstance(v, torch.Tensor):
        return v.detach().resolve_conj().numpy()
    return v


def assert_same(got, want, special=False, what=""):
    """``got`` (the port's output) equals ``want`` (the reference's) in
    structure, dtype (up to §C.19) and value (module tolerances)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), what
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, special, f"{what}[{i}]")
        return
    if not isinstance(want, (RefTensor, np.ndarray)):
        assert got == want, (what, got, want)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype == w.dtype or (g.dtype == np.int64
                                  and w.dtype == np.int32), \
        (what, g.dtype, w.dtype)
    if g.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-4 if special else 1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=what)


@pytest.fixture
def on_cpu():
    """The port's default device set to the CPU, restored after."""
    prev = tdevice._default
    T.set_device("cpu")
    yield
    tdevice._default = prev


#: cases whose reference output is not the port's to compare in full
#: (each checked below on its own terms)
_OWN = {"cummax", "cummin"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_against_reference(case, on_cpu):
    name = case.split(":")[0]
    rng = case_rng(case)
    args, kwargs = CASES[case](rng)
    want = getattr(P, name)(*map(_ref_arg, args),
                            **{k: _ref_arg(v) for k, v in kwargs.items()})
    got = getattr(T, name)(*map(port_arg, args),
                           **{k: port_arg(v) for k, v in kwargs.items()})
    if name in _OWN:
        values, indices = got
        assert want[1] is None  # the reference returns no indices (§C.23)
        assert_same(values, want[0], what=case)
        x = torch.from_numpy(np.array(args[0]))
        axis = kwargs.get("axis")
        x = x.reshape(-1) if axis is None else x.movedim(axis, -1)
        idx = indices if axis is None else indices.movedim(axis, -1)
        picked = torch.gather(x, -1, idx)
        assert torch.equal(picked, values if axis is None
                           else values.movedim(axis, -1))
        assert indices.dtype == torch.int64
        return
    assert_same(got, want, special=name in SPECIAL, what=case)


def _dtypes(v):
    """The dtype names and shapes of an output, in its structure."""
    if isinstance(v, (list, tuple)):
        return [_dtypes(x) for x in v]
    if isinstance(v, torch.Tensor):
        name = str(v.dtype).removeprefix("torch.")
    elif isinstance(v, RefTensor):
        name = np.asarray(raw(v)).dtype.name
    else:
        return type(v).__name__
    return name.replace("int64", "int32"), tuple(v.shape)


def _under_amp(pkg, level, name, args, kwargs, convert):
    with pkg.amp.auto_cast(level=level):
        return getattr(pkg, name)(*map(convert, args),
                                  **{k: convert(v) for k, v in kwargs.items()})


@pytest.mark.parametrize("case", sorted(c for c in CASES if ":" not in c))
def test_o2_cast_points_match_reference(case, on_cpu):
    """Under ``auto_cast(level="O2")`` every op but the black-listed runs
    in bf16 in the reference's gateway, tensors inside list arguments
    included: each port function (its first case) gives the reference's
    output dtypes (§C.19 aside), or both refuse bf16."""
    name = case.split(":")[0]
    args, kwargs = CASES[case](case_rng(case))
    outs = []
    for pkg, convert in ((P, _ref_arg), (T, port_arg)):
        try:
            outs.append(_under_amp(pkg, "O2", name, args, kwargs, convert))
        except (TypeError, RuntimeError, NotImplementedError):
            outs.append(None)
    want, got = outs
    if name in _OWN:  # the reference returns no indices (§C.23)
        want, got = want[0], got[0]
    assert (want is None) == (got is None), case
    assert _dtypes(got) == _dtypes(want), case


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("case", ["matmul", "bmm", "mv", "mm", "exp", "log",
                                  "tanh", "concat"])
def test_amp_lists_match_reference(case, level, on_cpu):
    """The white-listed products run in bf16 and the black-listed ``exp`` /
    ``log`` in f32 at O1 and O2 on both sides; others as given at O1."""
    args, kwargs = CASES[case](case_rng(case))
    want = _under_amp(P, level, case, args, kwargs, _ref_arg)
    got = _under_amp(T, level, case, args, kwargs, port_arg)
    assert _dtypes(got) == _dtypes(want)


def test_mean_of_integers_is_float32(on_cpu):
    """The repair: the port's ``mean`` of int32 / int64 / bool gives the
    reference's float32 mean (torch's own raises)."""
    x = np.arange(4)
    for dt in (np.int32, np.int64):
        got = T.mean(torch.from_numpy(x.astype(dt)))
        assert got.dtype == torch.float32 and float(got) == 1.5
        assert_same(got, P.mean(P.to_tensor(x.astype(dt))))
    got = T.mean(torch.tensor([True, False, True, True]))
    assert got.dtype == torch.float32 and float(got) == 0.75


def test_in_place_ops_write_their_input(on_cpu):
    x = torch.arange(6.0).reshape(2, 3)
    assert T.reshape_(x, [3, 2]) is x and x.shape == (3, 2)
    assert T.unsqueeze_(x, 0) is x and x.shape == (1, 3, 2)
    assert T.squeeze_(x, 0) is x and x.shape == (3, 2)
    assert T.cast_(x, "int32") is x and x.dtype == torch.int32
    y = torch.zeros(3)
    T.scatter_(y, torch.tensor([1]), torch.tensor([5.0]))
    T.masked_fill_(y, torch.tensor([True, False, False]), 2.0)
    T.clip_(y, max=4.0)
    T.index_fill_(y, torch.tensor([2]), 0, -1.0)
    assert y.tolist() == [2.0, 4.0, -1.0]
    z = torch.tensor([1.0, 2.0])
    assert T.where_(torch.tensor([True, False]), z, torch.zeros(2)) is z
    assert z.tolist() == [1.0, 0.0]


def test_as_strided_against_numpy(on_cpu):
    """The reference refuses ``as_strided`` (a TPU array has no strides);
    the port's view equals numpy's of the same storage."""
    a = np.arange(12, dtype=np.float32)
    with pytest.raises(NotImplementedError):
        P.as_strided(P.to_tensor(a), [3, 3], [2, 1])
    got = T.as_strided(torch.from_numpy(a), [3, 3], [2, 1], 1)
    want = np.lib.stride_tricks.as_strided(a[1:], (3, 3), (8, 4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paddle_semantics_differ_from_torch(on_cpu):
    """Where Paddle's call differs from torch's of the same name."""
    x = torch.arange(12.0).reshape(6, 2)
    assert [p.shape[0] for p in T.split(x, 3)] == [2, 2, 2]  # a count
    with pytest.raises(ValueError):
        T.split(x, 4)
    assert T.gather(x, torch.tensor([5, 0])).tolist() == [[10, 11], [0, 1]]
    assert T.squeeze(torch.zeros(2, 1), axis=0).shape == (2, 1)
    assert T.expand(torch.zeros(3, 1), [2, -1, 4]).shape == (2, 3, 4)
    assert T.max(x, axis=0).tolist() == [10, 11]  # values only
    assert T.median(torch.tensor([1.0, 2, 3, 4])).item() == 2.5
    # a 0 in reshape's shape (Paddle: "keep this axis") raises in both
    # packages (ROADMAP §C.22)
    ref = P.to_tensor(np.zeros((2, 3), np.float32))
    with pytest.raises(ZeroDivisionError):
        P.reshape(ref, [0, -1])
    with pytest.raises(TypeError):
        P.reshape(ref, [0, 3])
    for shape in ([0, -1], [0, 3]):
        with pytest.raises(RuntimeError):
            T.reshape(torch.zeros(2, 3), shape)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_draws(name, on_cpu):
    args, kwargs, dtype, check = RANDOM[name]
    ref = _np(getattr(P, name)(*args, **kwargs))
    T.seed(11)
    a = getattr(T, name)(*args, **kwargs)
    T.seed(11)
    b = getattr(T, name)(*args, **kwargs)
    assert a.shape == ref.shape and str(a.dtype) == f"torch.{dtype}"
    assert ref.dtype.name in (dtype, "int32")
    assert torch.equal(a, b)
    assert check(a.numpy().astype(np.float64)), name


@pytest.mark.parametrize("name", sorted(RANDOM_LIKE))
def test_random_draws_like(name, on_cpu):
    x, args, kwargs, check = RANDOM_LIKE[name]
    ref = _np(getattr(P, name)(P.to_tensor(x.copy()), *args, **kwargs))
    draws = []
    for _ in range(2):
        T.seed(5)
        draws.append(getattr(T, name)(torch.from_numpy(x.copy()), *args,
                                      **kwargs))
    a, b = draws
    assert a.shape == ref.shape
    assert a.dtype == torch.from_numpy(np.zeros(0, ref.dtype)).dtype or (
        a.dtype == torch.int64 and ref.dtype == np.int32)
    assert torch.equal(a, b)
    assert check(a.numpy().astype(np.float64), x), name


def test_binomial_draws(on_cpu):
    count = np.full(2000, 10, np.int32)
    prob = np.full(2000, 0.3, np.float32)
    ref = _np(P.binomial(P.to_tensor(count), P.to_tensor(prob)))
    T.seed(3)
    a = T.binomial(torch.from_numpy(count), torch.from_numpy(prob))
    T.seed(3)
    b = T.binomial(torch.from_numpy(count), torch.from_numpy(prob))
    assert a.shape == ref.shape and a.dtype == torch.int64
    assert torch.equal(a, b) and a.min() >= 0 and a.max() <= 10
    assert abs(a.double().mean() - 3) < 0.2


def test_seeded_draws_repeat_without_the_global_state(on_cpu):
    """``seed=`` draws from a generator of its own: equal draws for one
    seed whatever the global state, and the global stream untouched."""
    T.seed(1)
    a = T.uniform([5], seed=42)
    g1 = T.rand([3])
    T.seed(2)
    b = T.uniform([5], seed=42)
    c = T.gaussian([5], seed=42)
    T.seed(1)
    T.uniform([5], seed=42)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(T.rand([3]), g1)


def _public(mod):
    """The public names of ``mod`` that are API: not the modules, typing
    names and ``__future__`` feature it imports."""
    return {name for name, obj in vars(mod).items()
            if not name.startswith("_") and name != "annotations"
            and getattr(obj, "__module__", None) != "typing"
            and not (isinstance(obj, types.ModuleType)
                     and not obj.__name__.startswith(mod.__name__ + "."))}


def test_every_reference_name_is_ported_or_deferred():
    ref = _public(paddle_tpu.tensor)
    port = set(paddle_tpu_torch.tensor.__all__)
    assert not DEFERRED & port
    missing = sorted(ref - DEFERRED - port
                     - {"creation", "linalg", "logic", "manipulation",
                        "math", "random"})
    assert not missing, missing
    for sub in ("creation", "linalg", "logic", "manipulation", "math",
                "random"):
        assert hasattr(paddle_tpu_torch.tensor, sub)
    # each ported name of the reference has a sweep case
    cased = {c.split(":")[0] for c in CASES} | set(RANDOM) | \
        set(RANDOM_LIKE) | {"binomial", "as_strided"}
    assert not sorted((ref & port) - cased), sorted((ref & port) - cased)


def test_deferred_names_are_in_the_roadmap():
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    a9b = text[text.index("- **A.9b."):]
    a9b = a9b[:a9b.index("\n- **A.2.")]
    absent = sorted(n for n in DEFERRED if f"`{n}`" not in a9b)
    assert not absent, absent


def test_top_level_reexports(on_cpu):
    """The reference's top level re-exports its tensor functions; so does
    the port's, with ``paddle.slice``, ``einsum`` and ``paddle.linalg``."""
    for name in paddle_tpu_torch.tensor.__all__:
        assert getattr(T, name) is getattr(paddle_tpu_torch.tensor, name)
        assert name in T.__all__
    assert T.slice is paddle_tpu_torch.tensor.manipulation.paddle_slice
    assert T.linalg.norm is paddle_tpu_torch.tensor.linalg.norm
    assert T.bool is torch.bool and T.float32 is torch.float32
