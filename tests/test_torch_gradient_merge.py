"""``strategy.gradient_merge`` of the PyTorch port against the reference:
the nine cases of ``tests/test_gradient_merge.py`` run in both packages on
the same ``Linear(8, 4)`` weights and data, and the merge under
``DistTrainStep`` at dp 2 (one spawn of 2 gloo ranks) against the
reference's DistTrainStep at dp 2.

The reference's functional cases call ``functional_step`` with the
gradients given; the port's optimizers read ``.grad``, so there the same
gradients are set on the parameters (None where the reference passes
None) before ``step()``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import GradientMergeOptimizer
from paddle_tpu_torch.jit import TrainStep

from test_torch_fleet import (LOSS_RTOL, _assert_params_close, _batches,
                              _ref_loss_fn, _ref_model)
from torch_port_utils import (fleet_adamw, fleet_jobs, join_ranks, no_mesh,
                              numpy_state, spawn_ranks)

# tests/test_gradient_merge.py's tolerance
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _no_hybrid_group():
    """The reference's optimizers see no fleet group another test left."""
    with no_mesh():
        yield


def _data():
    rs = np.random.RandomState(0)
    return rs.randn(8, 8).astype("float32"), rs.randn(8, 4).astype("float32")


def _ref_linear():
    paddle.seed(3)
    return ref_nn.Linear(8, 4)


def _port_linear(ref):
    m = tpaddle.nn.Linear(8, 4, device="cpu")
    m.set_state_dict({n: np.asarray(raw(p))
                      for n, p in ref.named_parameters()})
    return m


def _strategy(pkg_fleet, k, avg=True):
    s = pkg_fleet.DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": k, "avg": avg}
    return s


def _ref_mse(mm, a, b):
    return paddle.mean((mm(a) - b) ** 2)


def _mse(mm, a, b):
    return torch.mean((mm(a) - b) ** 2)


def _both(opt_name, k, clip=None, **kw):
    """``(ref model, ref merged optimizer, port model, port merged
    optimizer)`` through each package's ``distributed_optimizer``."""
    ref = _ref_linear()
    port = _port_linear(ref)
    ref_clip = paddle.nn.ClipGradByGlobalNorm(clip) if clip else None
    port_clip = topt.ClipGradByGlobalNorm(clip) if clip else None
    ref_opt = ref_fleet.distributed_optimizer(
        getattr(paddle.optimizer, opt_name)(
            parameters=ref.parameters(), grad_clip=ref_clip, **kw),
        _strategy(ref_fleet, k))
    port_opt = fleet.distributed_optimizer(
        getattr(topt, opt_name)(parameters=port.parameters(),
                                grad_clip=port_clip, **kw),
        _strategy(fleet, k))
    return ref, ref_opt, port, port_opt


def _w(m):
    return {n: (np.asarray(raw(p)) if hasattr(p, "_value")
                else p.detach().numpy().copy())
            for n, p in m.named_parameters()}


def _close(got, want):
    for n, v in want.items():
        np.testing.assert_allclose(got[n], v, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def _train_steps(ref, ref_opt, port, port_opt, halves):
    x, y = _data()
    rs = RefTrainStep(ref, _ref_mse, ref_opt)
    ps = TrainStep(port, _mse, port_opt)
    for lo, hi in halves:
        rs(paddle.to_tensor(x[lo:hi]), paddle.to_tensor(y[lo:hi]))
        ps(torch.from_numpy(x[lo:hi]), torch.from_numpy(y[lo:hi]))


def _full_batch(opt_name, clip=None, **kw):
    """The port's one plain step on the whole batch."""
    x, y = _data()
    m = _port_linear(_ref_linear())
    c = topt.ClipGradByGlobalNorm(clip) if clip else None
    opt = getattr(topt, opt_name)(parameters=m.parameters(), grad_clip=c,
                                  **kw)
    TrainStep(m, _mse, opt)(torch.from_numpy(x), torch.from_numpy(y))
    return _w(m)


@pytest.mark.parametrize("opt_name, clip, kw", [
    ("Momentum", None, dict(learning_rate=0.1, momentum=0.9)),
    ("SGD", 0.01, dict(learning_rate=0.1))],
    ids=["functional_matches_full_batch", "with_global_norm_clip"])
def test_merged_train_step_matches_full_batch(opt_name, clip, kw):
    """``test_gradient_merge_functional_matches_full_batch`` and
    ``_with_global_norm_clip``: two half batches through the merged
    optimizer (the clip on the merged gradient) are one full-batch step,
    and the reference's merged run."""
    ref, ref_opt, port, port_opt = _both(opt_name, 2, clip, **kw)
    _train_steps(ref, ref_opt, port, port_opt, ((0, 4), (4, 8)))
    _close(_w(port), _w(ref))
    _close(_w(port), _full_batch(opt_name, clip, **kw))


def test_skip_steps_leave_params():
    ref, ref_opt, port, port_opt = _both("SGD", 3, learning_rate=0.1)
    w0 = _w(port)
    for i in range(3):
        _train_steps(ref, ref_opt, port, port_opt, ((0, 4),))
        if i < 2:
            for n, v in w0.items():
                np.testing.assert_array_equal(_w(port)[n], v)
    assert np.abs(_w(port)["weight"] - w0["weight"]).max() > 1e-7
    _close(_w(port), _w(ref))


def test_checkpoint_roundtrip():
    """A mid-cycle ``state_dict`` carries the inner moments and the merge
    accumulator: a fresh run restored from it continues the trajectory."""
    ref, ref_opt, port, port_opt = _both("Momentum", 2, learning_rate=0.1,
                                         momentum=0.9)
    _train_steps(ref, ref_opt, port, port_opt, ((0, 4), (4, 8), (0, 4)))
    sd = port_opt.state_dict()
    keys = "".join(sd.keys())
    assert "gm_acc" in keys and "inner_velocity" in keys, sorted(sd)
    snapshot = _w(port)
    _train_steps(ref, ref_opt, port, port_opt, ((4, 8),))
    _close(_w(port), _w(ref))
    m2 = tpaddle.nn.Linear(8, 4, device="cpu")
    m2.set_state_dict(snapshot)
    opt2 = fleet.distributed_optimizer(
        topt.Momentum(learning_rate=0.1, momentum=0.9,
                      parameters=m2.parameters()), _strategy(fleet, 2))
    opt2.set_state_dict(sd)
    x, y = _data()
    TrainStep(m2, _mse, opt2)(torch.from_numpy(x[4:]), torch.from_numpy(y[4:]))
    _close(_w(m2), _w(port))


def _eager(model, opt, halves, to):
    x, y = _data()
    for lo, hi in halves:
        loss = ((model(to(x[lo:hi])) - to(y[lo:hi])) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def test_eager_matches_full_batch():
    ref, ref_opt, port, port_opt = _both("SGD", 2, learning_rate=0.1)
    _eager(ref, ref_opt, ((0, 4), (4, 8)), paddle.to_tensor)
    _eager(port, port_opt, ((0, 4), (4, 8)), torch.from_numpy)
    _close(_w(port), _w(ref))
    _close(_w(port), _full_batch("SGD", learning_rate=0.1))


def test_eager_midcycle_checkpoint():
    """A checkpoint between boundaries resumes the cycle exactly."""
    _, _, port, port_opt = _both("SGD", 2, learning_rate=0.1)
    _eager(port, port_opt, ((0, 4),), torch.from_numpy)
    sd = port_opt.state_dict()
    assert any("gm_acc" in k for k in sd), sorted(sd)
    _eager(port, port_opt, ((4, 8),), torch.from_numpy)
    m2 = _port_linear(_ref_linear())
    opt2 = fleet.distributed_optimizer(
        topt.SGD(learning_rate=0.1, parameters=m2.parameters()),
        _strategy(fleet, 2))
    opt2.set_state_dict(sd)
    _eager(m2, opt2, ((4, 8),), torch.from_numpy)
    _close(_w(m2), _w(port))


def _functional(inner_name, grads_per_step, **kw):
    """The reference's ``functional_step`` and the port's ``step`` on the
    given gradients (lists per micro-step, None where absent): the
    parameters after each, and the port's merge state."""
    ref = _ref_linear()
    port = _port_linear(ref)
    gm_ref = ref_fleet.GradientMergeOptimizer(
        getattr(paddle.optimizer, inner_name)(parameters=ref.parameters(),
                                              **kw), k_steps=2, avg=True)
    gm = GradientMergeOptimizer(
        getattr(topt, inner_name)(parameters=port.parameters(), **kw),
        k_steps=2, avg=True)
    states = gm_ref.functional_states()
    p_vals = [raw(p) for p in ref.parameters()]
    out = []
    for grads in grads_per_step:
        p_vals, states = gm_ref.functional_step(
            p_vals, [None if g is None else jnp.asarray(g) for g in grads],
            states, 0.1)
        for p, g in zip(port.parameters(), grads):
            p.grad = None if g is None else torch.from_numpy(g)
        gm.step()
        out.append(([np.asarray(v) for v in p_vals],
                    [p.detach().numpy().copy() for p in port.parameters()],
                    gm.state_dict(), states))
    return out


def test_ctr_advances_without_grad():
    """The cycle counter advances for every parameter when some parameter
    has a gradient; the boundary zeroes every accumulator."""
    ones = [np.ones((8, 4), np.float32), np.ones(4, np.float32)]
    out = _functional("SGD", [[ones[0], None], ones], learning_rate=0.1)
    (_, _, sd1, st1), (ref_p, port_p, sd2, st2) = out
    assert int(sd1["param_1.gm_ctr"]) == int(st1[1]["gm_ctr"]) == 1
    assert int(sd2["param_0.gm_ctr"]) == int(st2[0]["gm_ctr"]) == 2
    assert float(np.abs(sd2["param_1.gm_acc"].numpy()).max()) == 0.0
    for a, b in zip(port_p, ref_p):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_nonlive_at_boundary_applies_accumulated():
    """A parameter with a gradient mid-cycle and none at the boundary gets
    its merged gradient at the boundary (SGD: -0.1 * 1 / 2), with no leak
    into the next cycle; one with none all cycle is left untouched."""
    ones = [np.ones((8, 4), np.float32), np.ones(4, np.float32)]
    out = _functional("SGD", [ones, [ones[0], None], [ones[0], None],
                              [ones[0], None]], learning_rate=0.1)
    b0 = _port_linear(_ref_linear()).bias.detach().numpy()
    np.testing.assert_allclose(out[1][1][1], b0 - 0.05, rtol=1e-6,
                               atol=1e-7)
    assert float(np.abs(out[1][2]["param_1.gm_acc"].numpy()).max()) == 0.0
    np.testing.assert_array_equal(out[3][1][1], out[1][1][1])
    for ref_p, port_p, _, _ in out:
        for a, b in zip(port_p, ref_p):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_exact_zero_grad_still_updates_at_boundary():
    """An exactly-zero gradient mid-cycle counts as one: AdamW's decay
    lands at the boundary though the boundary brings no gradient."""
    zero_w = np.zeros((8, 4), np.float32)
    ones_b = np.ones(4, np.float32)
    out = _functional("AdamW", [[zero_w, ones_b], [None, ones_b]],
                      learning_rate=0.1, weight_decay=0.1)
    w0 = _port_linear(_ref_linear()).weight.detach().numpy()
    ref_p, port_p, _, _ = out[-1]
    assert np.abs(port_p[0] - w0).max() > 1e-8
    for a, b in zip(port_p, ref_p):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# -- under DistTrainStep at dp 2 ----------------------------------------------
K_STEPS = 2


def _ref_dist_merge(state, batch):
    """The reference's DistTrainStep at dp 2 with gradient merge over
    ``K_STEPS`` micro-batches (the halves of the batch), 2 cycles."""
    with no_mesh():
        s = _strategy(ref_fleet, K_STEPS)
        s.hybrid_configs.update(dp_degree=2)
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_model("gpt", state)
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        m = ref_fleet.distributed_model(m)
        opt = ref_fleet.distributed_optimizer(opt, s)
        step = ref_fleet.DistTrainStep(m, _ref_loss_fn(batch), opt)
        losses = []
        for _ in range(2):
            for half in (slice(0, 2), slice(2, 4)):
                losses.append(float(np.asarray(raw(step(
                    Tensor(jnp.asarray(batch["ids"][half])),
                    Tensor(jnp.asarray(batch["labels"][half])))))))
        return losses, {n: np.asarray(raw(p)) for n, p in
                        m.named_parameters()}


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    batches = _batches()
    with no_mesh():
        states = {"gpt": numpy_state(_ref_model("gpt", None))}
    out = tmp_path_factory.mktemp("gm")
    jobs = [dict(name="gm_dp2", kind="merge", model="gpt", dp=2,
                 k_steps=K_STEPS)]
    ctx = spawn_ranks(fleet_jobs, 2, out, jobs, states, batches)
    try:
        ref = _ref_dist_merge(states["gpt"], batches["gpt"])
    finally:
        port = join_ranks(ctx, out)
    return port, ref


def test_gradient_merge_under_dist_train_step(dist_runs):
    """Gradient merge (k = 2, AdamW with its clip) under DistTrainStep at
    dp 2: 4 micro-batches, 2 updates, against the reference's; the
    parameters move only at the boundaries."""
    port, (want_losses, want) = dist_runs
    got = port[0]["gm_dp2"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params_close(got["full"], want)
    assert got["moved"] == [False, True, False, True]
    assert port[1]["gm_dp2"]["losses"] == got["losses"]
