"""``paddle_tpu_torch.autograd`` and ``paddle.grad`` against the reference
on the CPU: the reference's own cases (``tests/test_autograd.py``) on the
port's API, ``PyLayer`` with a non-tensor argument and an integer tensor
(one gradient per floating tensor input), ``grad`` leaving ``.grad``
alone and its ``allow_unused`` / ``create_graph`` contract, and
``Jacobian`` / ``Hessian`` (plain and batched) / ``jacobian`` / ``vjp`` /
``jvp`` against the reference's on the same numpy inputs, within 1e-5
relative (f32; the two sides order their sums differently), and
``saved_tensors_hooks`` seeing every saved tensor. The hooks inside a
ZeRO-3 forward (no gathered weight kept alive) run on four ranks in
``tests/test_torch_lamb_fleet.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import autograd as rag
import paddle_tpu_torch as tp
from paddle_tpu_torch import autograd as ag

RTOL, ATOL = 1e-5, 1e-6
rng = np.random.RandomState(1)


@pytest.fixture(autouse=True)
def on_cpu():
    from paddle_tpu_torch import device as tdevice

    prev = tdevice._default
    tp.set_device("cpu")
    yield
    tdevice._default = prev


def _x(a):
    return tp.to_tensor(a, stop_gradient=False)


def test_simple_chain():
    a = rng.rand(3, 3).astype(np.float32)
    x = _x(a)
    ag.backward((x * x + 2 * x).sum())
    np.testing.assert_allclose(x.grad.numpy(), 2 * a + 2, rtol=1e-5)


def test_matches_jax_grad():
    a = rng.rand(4, 4).astype(np.float32)
    b = rng.rand(4, 4).astype(np.float32)

    def f(x, y):
        return jnp.sum(jnp.tanh(x @ y) * jnp.exp(y * 0.1))

    gx_ref, gy_ref = jax.grad(f, argnums=(0, 1))(a, b)
    x, y = _x(a), _x(b)
    loss = (tp.tanh(tp.matmul(x, y)) * tp.exp(y * 0.1)).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), gx_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), gy_ref, rtol=1e-4, atol=1e-5)


def test_retain_graph_and_grad_tensor():
    a = rng.rand(3).astype(np.float32)
    x = _x(a)
    y = (x * x).sum()
    ag.backward(y, retain_graph=True)
    ag.backward(y)
    np.testing.assert_allclose(x.grad.numpy(), 4 * a, rtol=1e-5)
    z = _x(a)
    ag.backward(z * 2, tp.to_tensor(np.array([1.0, 2.0, 3.0], np.float32)))
    np.testing.assert_allclose(z.grad.numpy(), [2.0, 4.0, 6.0])
    with pytest.raises(RuntimeError):
        ag.backward(y)


@pytest.mark.parametrize("api", ["autograd.grad", "paddle.grad"])
def test_grad_leaves_dot_grad_alone(api):
    fn = ag.grad if api == "autograd.grad" else tp.grad
    a = rng.rand(3).astype(np.float32)
    x = _x(a)
    x.grad = torch.full((3,), 7.0)
    (g,) = fn([(x ** 3).sum()], [x])
    np.testing.assert_allclose(g.numpy(), 3 * a ** 2, rtol=1e-4)
    np.testing.assert_array_equal(x.grad.numpy(), np.full(3, 7.0))
    ref = rag.grad([(paddle.to_tensor(a, stop_gradient=False) ** 3).sum()],
                   [paddle.to_tensor(a, stop_gradient=False)],
                   allow_unused=True)
    assert len(ref) == 1  # the reference returns a list too


def test_grad_allow_unused_and_create_graph():
    x, u = _x(np.ones(2, np.float32)), _x(np.ones(2, np.float32))
    y = (x * 2).sum()
    with pytest.raises(RuntimeError, match="unused"):
        ag.grad(y, [x, u], retain_graph=True)
    gx, gu = ag.grad(y, [x, u], retain_graph=True, allow_unused=True)
    assert gu is None and torch.equal(gx, torch.full((2,), 2.0))
    with pytest.raises(NotImplementedError):
        ag.grad(y, x, create_graph=True)
    with pytest.raises(NotImplementedError):
        rag.grad(paddle.to_tensor([1.0]), paddle.to_tensor([1.0]),
                 create_graph=True)


def _square(pkg_ag):
    class Square(pkg_ag.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, gy):
            (x,) = ctx.saved_tensor()
            return gy * x * 2

    return Square


def _scaled_index(pkg_ag, index_add):
    """``x[idx] * k + y + shift``: a float tensor, an integer tensor, a
    float, a float tensor and a keyword; backward returns one gradient per
    floating tensor input (x, y)."""

    class ScaledIndex(pkg_ag.PyLayer):
        @staticmethod
        def forward(ctx, x, idx, k, y, shift=0.0):
            ctx.save_for_backward(x, idx)
            ctx.k = k
            return x[idx] * k + y + shift

        @staticmethod
        def backward(ctx, g):
            x, idx = ctx.saved_tensor()
            return index_add(x, idx, g * ctx.k), g

    return ScaledIndex


def _ref_index_add(x, idx, v):
    out = np.zeros(x.shape, np.float32)
    np.add.at(out, np.asarray(idx.numpy()), np.asarray(v.numpy()))
    return paddle.to_tensor(out)


def _port_index_add(x, idx, v):
    return torch.zeros_like(x).index_add(0, idx, v)


def test_pylayer_square():
    a = rng.rand(3).astype(np.float32)
    Square = _square(ag)
    x = _x(a)
    Square.apply(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * a, rtol=1e-6)


def test_pylayer_with_non_tensor_and_integer_arguments():
    a = rng.rand(4).astype(np.float32)
    b = rng.rand(3).astype(np.float32)
    idx = np.array([0, 2, 2], np.int64)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    RefOp = _scaled_index(rag, _ref_index_add)
    PortOp = _scaled_index(ag, _port_index_add)
    rx, ry = (paddle.to_tensor(v, stop_gradient=False) for v in (a, b))
    rout = RefOp.apply(rx, paddle.to_tensor(idx), 3.0, ry, shift=1.0)
    (rout * paddle.to_tensor(w)).sum().backward()
    px, py = _x(a), _x(b)
    pout = PortOp.apply(px, torch.from_numpy(idx), 3.0, py, shift=1.0)
    (pout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(pout.detach().numpy(), rout.numpy(),
                               rtol=RTOL)
    np.testing.assert_allclose(px.grad.numpy(), rx.grad.numpy(), rtol=RTOL)
    np.testing.assert_allclose(py.grad.numpy(), ry.grad.numpy(), rtol=RTOL)


def _f(pkg):
    def f(x, y):
        return pkg.tanh(x * y).sum(), x * pkg.exp(y)
    return f


def _g(pkg):
    def g(x):
        return (x * x * x).sum() + (x[0] * x[1:]).sum()
    return g


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def test_jacobian_class_matches_reference():
    a = rng.rand(3).astype(np.float32)
    b = rng.rand(3).astype(np.float32)
    ref = rag.Jacobian(_f(paddle), [paddle.to_tensor(a),
                                    paddle.to_tensor(b)])
    port = ag.Jacobian(_f(tp), [tp.to_tensor(a), tp.to_tensor(b)])
    assert port.shape == ref.shape == [4, 6]
    np.testing.assert_allclose(_np(port[:]), _np(ref[:]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_np(port[1, 2:4]), _np(ref[1, 2:4]),
                               rtol=RTOL, atol=ATOL)


def test_batched_jacobian_and_hessians_match_reference():
    xb = rng.rand(2, 3).astype(np.float32)

    def per_row(pkg):
        return lambda x: pkg.tanh(x) * x.sum(-1, keepdim=True)

    ref = rag.Jacobian(per_row(paddle), paddle.to_tensor(xb),
                       is_batched=True)
    port = ag.Jacobian(per_row(tp), tp.to_tensor(xb), is_batched=True)
    assert port.shape == ref.shape == [2, 3, 3]
    np.testing.assert_allclose(_np(port[:]), _np(ref[:]), rtol=RTOL,
                               atol=ATOL)
    x = rng.rand(4).astype(np.float32)
    ref = rag.Hessian(_g(paddle), paddle.to_tensor(x))
    port = ag.Hessian(_g(tp), tp.to_tensor(x))
    np.testing.assert_allclose(_np(port[:]), _np(ref[:]), rtol=RTOL,
                               atol=ATOL)

    def sq(pkg):
        return lambda v: (v * v * v).sum()

    ref = rag.Hessian(sq(paddle), paddle.to_tensor(xb), is_batched=True)
    port = ag.Hessian(sq(tp), tp.to_tensor(xb), is_batched=True)
    assert port.shape == ref.shape == [2, 3, 3]
    np.testing.assert_allclose(_np(port[:]), _np(ref[:]), rtol=RTOL,
                               atol=ATOL)


def test_vjp_jvp_match_reference():
    a = rng.rand(3).astype(np.float32)
    b = rng.rand(3).astype(np.float32)
    v = rng.rand(3).astype(np.float32)

    def h(pkg):
        return lambda x, y: pkg.sin(x) * y

    rout, rg = rag.vjp(h(paddle), [paddle.to_tensor(a), paddle.to_tensor(b)],
                       paddle.to_tensor(v))
    pout, pg = ag.vjp(h(tp), [tp.to_tensor(a), tp.to_tensor(b)],
                      tp.to_tensor(v))
    np.testing.assert_allclose(_np(pout), _np(rout), rtol=RTOL)
    for p, r in zip(pg, rg):
        np.testing.assert_allclose(_np(p), _np(r), rtol=RTOL, atol=ATOL)
    rout, rj = rag.jvp(h(paddle), [paddle.to_tensor(a), paddle.to_tensor(b)],
                       [paddle.to_tensor(v), paddle.to_tensor(a)])
    pout, pj = ag.jvp(h(tp), [tp.to_tensor(a), tp.to_tensor(b)],
                      [tp.to_tensor(v), tp.to_tensor(a)])
    np.testing.assert_allclose(_np(pj), _np(rj), rtol=RTOL, atol=ATOL)
    _, pg1 = ag.vjp(lambda x: (x * x).sum(), tp.to_tensor(a))
    np.testing.assert_allclose(_np(pg1), 2 * a, rtol=RTOL)


def test_jacobian_of_computed_tensors_matches_reference():
    a = rng.rand(2, 3).astype(np.float32)
    w = rng.rand(3, 2).astype(np.float32)
    rx, rw = (paddle.to_tensor(v, stop_gradient=False) for v in (a, w))
    ref = rag.jacobian(paddle.matmul(rx, rw) ** 2, [rx, rw], batch_axis=0)
    px, pw = _x(a), _x(w)
    port = ag.jacobian(tp.matmul(px, pw) ** 2, [px, pw], batch_axis=0)
    for p, r in zip(port, ref):
        assert list(p.shape) == list(r.shape)
        np.testing.assert_allclose(_np(p), _np(r), rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        ag.hessian(px.sum(), px)


def test_saved_tensors_hooks_see_every_saved_tensor():
    packed, unpacked = [], []

    def pack(t):
        packed.append(tuple(t.shape))
        return t.clone()

    def unpack(t):
        unpacked.append(tuple(t.shape))
        return t

    a = rng.rand(3, 4).astype(np.float32)
    x = _x(a)
    with ag.saved_tensors_hooks(pack, unpack):
        y = (tp.tanh(x) * x).sum()
    assert packed
    y.backward()
    assert sorted(unpacked) == sorted(packed)
    np.testing.assert_allclose(
        x.grad.numpy(), np.tanh(a) + a * (1 - np.tanh(a) ** 2), rtol=1e-5)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        sharding_stage3 as z3)

    assert z3.user_hooks() == []  # the scope popped its pair


def test_grad_switches_and_names():
    assert ag.no_grad is torch.no_grad and tp.incubate.autograd is ag
    with ag.set_grad_enabled(False):
        assert not ag.is_grad_enabled()
        with ag.enable_grad():
            assert ag.is_grad_enabled()
    ref = {n for n, v in vars(rag).items() if not n.startswith("_")
           and getattr(v, "__module__", None) == rag.__name__}
    assert ref - {"PyLayerMeta", "is_grad_enabled_fn"} <= set(ag.__all__)
