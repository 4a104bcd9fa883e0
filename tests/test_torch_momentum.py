"""``SGD`` and ``Momentum`` of the PyTorch port (``paddle_tpu_torch/
optimizer``) against the reference's on the CPU: parameters and gradients
made with numpy from a seed, three steps on both sides through the
reference's ``functional_step`` (the update its ``TrainStep`` runs, the
learning rate an f32 scalar), with and without Nesterov, the float /
``L2Decay`` / ``L1Decay`` ``weight_decay``, ``ParamAttr`` rates and
regularizers, the global-norm clip; ``multi_precision`` masters on bf16
parameters (the reference's eager master arithmetic: its functional
update on the f32 master, the gradient read as f32); and the ``velocity``
entries of ``state_dict`` through ``.pdopt`` files both ways.

Tolerance: f32 parameters and velocities within 1e-6 relative (the same
f32 operations in the same order; a fused multiply-add may round once
less on one side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.op import raw
from paddle_tpu.nn.layer import Parameter
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import io_state
from paddle_tpu_torch.nn import ParamAttr, create_parameter

LR = 0.1
STEPS = 3
SHAPES = ((6, 5), (5,), (2, 3, 3, 3))
RTOL = 1e-6


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _decay(pkg, kind):
    return {None: None, "float": 1e-4, "l2": pkg.optimizer.L2Decay(1e-3),
            "l1": pkg.optimizer.L1Decay(1e-3)}[kind]


# name -> (optimizer, keyword arguments, weight decay, clip, per-parameter
# ParamAttr of the first parameter or None)
CASES = {
    "momentum": ("Momentum", dict(momentum=0.9), None, None, None),
    "momentum-nesterov-wd": ("Momentum", dict(momentum=0.9,
                                              use_nesterov=True),
                             "float", None, None),
    "momentum-l2-clip": ("Momentum", dict(momentum=0.8), "l2", 1.0, None),
    "momentum-l1-nesterov": ("Momentum", dict(momentum=0.9,
                                              use_nesterov=True),
                             "l1", None, None),
    "momentum-param-attr": ("Momentum", dict(momentum=0.9), "float", None,
                            dict(learning_rate=0.5, regularizer="l1")),
    "sgd": ("SGD", {}, None, None, None),
    "sgd-wd-clip": ("SGD", {}, "float", 0.5, None),
}


def _ref_params(params, attr):
    ps = [Parameter(jnp.asarray(p)) for p in params]
    if attr:
        ps[0].optimize_attr["learning_rate"] = attr["learning_rate"]
        ps[0].regularizer = _decay(paddle, attr["regularizer"])
    return ps


def _port_params(params, attr):
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    if attr:
        import paddle_tpu_torch as tp

        from paddle_tpu_torch.nn import initializer as I

        ps[0] = create_parameter(
            params[0].shape, ParamAttr(
                initializer=I.Constant(0.0),
                learning_rate=attr["learning_rate"],
                regularizer=_decay(tp, attr["regularizer"])), device="cpu")
        with torch.no_grad():
            ps[0].copy_(torch.from_numpy(params[0]))
    return ps


def _make(pkg, name, kw, decay, clip, ps):
    opt_mod = pkg.optimizer
    clip = None if clip is None else opt_mod.ClipGradByGlobalNorm(clip)
    return getattr(opt_mod, name)(learning_rate=LR, parameters=ps,
                                  weight_decay=_decay(pkg, decay),
                                  grad_clip=clip, **kw)


def _reference(case, params, grads):
    name, kw, decay, clip, attr = CASES[case]
    ps = _ref_params(params, attr)
    opt = _make(paddle, name, kw, decay, clip, ps)
    vals = [raw(p) for p in ps]
    states = opt.functional_states()
    for gs in grads:
        vals, states = opt.functional_step(
            vals, [jnp.asarray(g) for g in gs], states,
            jnp.asarray(LR, jnp.float32))
    return vals, states


def _port(case, params, grads):
    import paddle_tpu_torch as tp

    name, kw, decay, clip, attr = CASES[case]
    ps = _port_params(params, attr)
    opt = _make(tp, name, kw, decay, clip, ps)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        opt.clear_grad()
    return ps, opt


@pytest.mark.parametrize("case", CASES)
def test_trajectory_matches_reference(case):
    params, grads = _data()
    want, ref_states = _reference(case, params, grads)
    got, opt = _port(case, params, grads)
    for i, (p, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=RTOL, err_msg=str(i))
        assert not np.allclose(p.detach().numpy(), params[i])
    for st, rst in zip(opt._accumulators, ref_states):
        assert set(st) == set(rst)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(rst[k]),
                                       rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("nesterov", [False, True])
def test_multi_precision_keeps_f32_masters_and_velocity(nesterov):
    """bf16 parameters with ``multi_precision``: the master follows the
    reference's f32 trajectory (its eager step's arithmetic: the update on
    the f32 master, the bf16 gradient read as f32), the velocity is f32
    and the parameter is its master rounded to bf16."""
    params, grads = _data(1)
    kw = dict(learning_rate=LR, momentum=0.9, use_nesterov=nesterov,
              weight_decay=1e-4)
    rps = [Parameter(jnp.asarray(p, jnp.bfloat16)) for p in params]
    ref = paddle.optimizer.Momentum(parameters=rps, multi_precision=True,
                                    **kw)
    vals = [jnp.asarray(p, jnp.bfloat16).astype(jnp.float32)
            for p in params]
    states = [{"velocity": jnp.zeros(v.shape, jnp.float32)} for v in vals]
    for gs in grads:
        vals, states = ref.functional_update(
            vals, [jnp.asarray(g, jnp.bfloat16).astype(jnp.float32)
                   for g in gs], states, jnp.asarray(LR, jnp.float32))
    ps = [torch.nn.Parameter(torch.from_numpy(p).bfloat16()) for p in params]
    opt = topt.Momentum(parameters=ps, multi_precision=True, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).bfloat16()
        opt.step()
    for i, (p, w, st) in enumerate(zip(ps, vals, states)):
        m = opt._master[i]
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert opt._accumulators[i]["velocity"].dtype == torch.float32
        np.testing.assert_allclose(m.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(
            opt._accumulators[i]["velocity"].numpy(),
            np.asarray(st["velocity"]), rtol=RTOL, atol=RTOL)
        assert torch.equal(p.detach(), m.bfloat16())


def test_velocity_interchanges_through_pdopt(tmp_path):
    """The port's ``param_{i}.velocity`` entries load into the reference's
    optimizer from a ``.pdopt`` it reads, and the reference's into the
    port's, value for value; a step after the reload agrees."""
    params, grads = _data(2)
    got, opt = _port("momentum-nesterov-wd", params, grads)
    io_state.save(opt.state_dict(), str(tmp_path / "port.pdopt"))
    want, ref_states = _reference("momentum-nesterov-wd", params, grads)
    ref_ps = [Parameter(v) for v in want]
    ref = _make(paddle, "Momentum", dict(momentum=0.9, use_nesterov=True),
                "float", None, ref_ps)
    ref.set_state_dict(paddle.load(str(tmp_path / "port.pdopt")))
    assert sorted(ref.state_dict()) == sorted(opt.state_dict()) == [
        f"param_{i}.velocity" for i in range(len(SHAPES))]
    for st, pst in zip(ref.functional_states(), opt._accumulators):
        np.testing.assert_array_equal(np.asarray(st["velocity"]),
                                      pst["velocity"].numpy())
    paddle.save(ref.state_dict(), str(tmp_path / "ref.pdopt"))
    back = topt.Momentum(learning_rate=LR, momentum=0.9, use_nesterov=True,
                         weight_decay=1e-4,
                         parameters=[torch.nn.Parameter(p.detach().clone())
                                     for p in got])
    back.set_state_dict(io_state.load(str(tmp_path / "ref.pdopt"),
                                      device="cpu"))
    for st, pst in zip(back._accumulators, opt._accumulators):
        assert torch.equal(st["velocity"], pst["velocity"])
    # one more step from the reloaded state on both sides
    g = [np.full(s, 0.5, np.float32) for s in SHAPES]
    vals, _ = ref.functional_step(
        [raw(p) for p in ref_ps], [jnp.asarray(x) for x in g],
        ref.functional_states(), jnp.asarray(LR, jnp.float32))
    for p, x in zip(back._parameter_list, g):
        p.grad = torch.from_numpy(x)
    back.step()
    for p, w in zip(back._parameter_list, vals):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=RTOL)
