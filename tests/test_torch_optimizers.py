"""The optimizers and clips of the PyTorch port (``paddle_tpu_torch/
optimizer``) against the reference's on the CPU: parameters and gradients
made with numpy from a seed, five steps of fixed gradients through the
reference's eager ``step`` (which reads ``.grad``, as the port's does) and
the port's, with and without ``weight_decay`` (float, L2, L1), the clips,
``multi_precision`` on bf16 parameters (f32 masters and state on both
sides) and an LR scheduler stepped between steps. Also: named parameters
(``ParamAttr(name=)``) keying the state as the reference keys it, Lamb's
and Lars's exclusions firing by name, ``state_dict`` key sets and a round
trip, LBFGS trajectories on a quadratic and on Rosenbrock, and the
reference's own Lars cases (``tests/test_optimizer.py``: the trust ratio
against a numpy replay, Lars under ``TrainStep``).

Tolerance: f32 parameters and state within 1e-6 relative (atol 1e-7 for
entries near 0): the same f32 operations in the same order, where a fused
multiply-add or a ``pow`` may round once differently on one side. bf16
parameters under ``multi_precision`` are the f32 masters rounded, compared
with the masters. LBFGS's trajectories within 1e-5 (its line search
compares losses on the host, and a difference in the last bit of a loss
can only move the step length by a whole halving, which the test would
see).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.op import raw
from paddle_tpu.nn.layer import Parameter as RefParameter
import paddle_tpu_torch as tp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn.layer import Parameter as PortParameter

LR = 0.05
STEPS = 5
SHAPES = ((6, 5), (5,), (2, 3, 4))
NAMES = ("linear_0.w_0", "linear_0.b_0", "conv_0.w_0")
RTOL, ATOL = 1e-6, 1e-7


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _decay(pkg, kind):
    return {None: None, "float": 1e-3, "l2": pkg.optimizer.L2Decay(1e-3),
            "l1": pkg.optimizer.L1Decay(1e-3)}[kind]


def _clip(pkg, kind):
    return {None: None,
            "value": lambda: pkg.optimizer.ClipGradByValue(0.5),
            "norm": lambda: pkg.optimizer.ClipGradByNorm(1.0),
            "global": lambda: pkg.optimizer.ClipGradByGlobalNorm(1.0)}[kind]


def _excl_bias(name):
    return "b_" in name


# name -> (optimizer, keyword arguments, weight decay, clip, bf16 with
# multi_precision, LR scheduler)
CASES = {
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1), None, None,
                False, False),
    "adagrad-l2-norm": ("Adagrad", {}, "l2", "norm", False, False),
    "adamax": ("Adamax", {}, None, None, False, False),
    "adamax-l1-value": ("Adamax", dict(beta1=0.8), "l1", "value", False,
                        False),
    "rmsprop": ("RMSProp", {}, None, None, False, False),
    "rmsprop-centered-momentum-sched": (
        "RMSProp", dict(centered=True, momentum=0.9), "float", None, False,
        True),
    "adadelta": ("Adadelta", dict(rho=0.9), None, None, False, False),
    "adadelta-l2-global": ("Adadelta", {}, "l2", "global", False, False),
    "asgd": ("ASGD", dict(batch_num=3), None, None, False, False),
    "asgd-float-sched": ("ASGD", dict(batch_num=2), "float", None, False,
                         True),
    "asgd-mp": ("ASGD", dict(batch_num=3), None, None, True, False),
    "rprop": ("Rprop", {}, None, None, False, False),
    "rprop-value-sched": ("Rprop", dict(etas=(0.4, 1.3)), None, "value",
                          False, True),
    "rprop-mp": ("Rprop", {}, None, None, True, False),
    "nadam": ("NAdam", {}, None, None, False, False),
    "nadam-l1-sched": ("NAdam", dict(momentum_decay=0.01), "l1", None, False,
                       True),
    "nadam-mp": ("NAdam", {}, "float", None, True, False),
    "radam": ("RAdam", dict(beta2=0.99), None, None, False, False),
    "radam-l2-norm": ("RAdam", dict(beta2=0.99), "l2", "norm", False, False),
    "radam-mp": ("RAdam", dict(beta2=0.99), None, None, True, False),
    "lamb": ("Lamb", {}, None, None, False, False),
    "lamb-exclude-global-sched": (
        "Lamb", dict(lamb_weight_decay=0.05,
                     exclude_from_weight_decay_fn=_excl_bias), None,
        "global", False, True),
    "lars": ("Lars", dict(lars_weight_decay=0.01), None, None, False, False),
    "lars-exclude-norm": ("Lars", dict(lars_weight_decay=0.01, epsilon=1e-6,
                                       exclude_from_weight_decay=["b_"]),
                          None, "norm", False, False),
    "lars-mp-sched": ("Lars", dict(exclude_from_weight_decay=["b_"]), None,
                      None, True, True),
}
TAKES_DECAY = {"Adagrad", "Adamax", "RMSProp", "Adadelta", "ASGD", "NAdam",
               "RAdam"}


def _make(pkg, case, params):
    name, kw, decay, clip, mp, sched = CASES[case]
    kw = dict(kw)
    if name in TAKES_DECAY:
        kw["weight_decay"] = _decay(pkg, decay)
    if clip:
        kw["grad_clip"] = _clip(pkg, clip)()
    if mp:
        kw["multi_precision"] = True
    lr = (pkg.optimizer.lr.StepDecay(LR, step_size=2, gamma=0.5) if sched
          else LR)
    return getattr(pkg.optimizer, name)(learning_rate=lr, parameters=params,
                                        **kw), (lr if sched else None)


def _ref_run(case, params, grads, steps=STEPS):
    mp = CASES[case][4]
    dt = jnp.bfloat16 if mp else jnp.float32
    ps = [RefParameter(jnp.asarray(p, dt), name=n)
          for p, n in zip(params, NAMES)]
    opt, sched = _make(paddle, case, ps)
    for gs in grads[:steps]:
        for p, g in zip(ps, gs):
            p.grad = jnp.asarray(g, dt)
        opt.step()
        if sched is not None:
            sched.step()
    return ps, opt


def _port_params(params, mp, named=True):
    dt = torch.bfloat16 if mp else torch.float32
    ps = [PortParameter(torch.from_numpy(p.copy()).to(dt)) for p in params]
    if named:
        for p, n in zip(ps, NAMES):
            p.name = n
    return ps


def _port_steps(opt, sched, ps, grads, mp):
    dt = torch.bfloat16 if mp else torch.float32
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy()).to(dt)
        opt.step()
        if sched is not None:
            sched.step()


def _port_run(case, params, grads):
    ps = _port_params(params, CASES[case][4])
    opt, sched = _make(tp, case, ps)
    _port_steps(opt, sched, ps, grads, CASES[case][4])
    return ps, opt


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(raw(v) if not isinstance(v, (int, float)) else v,
                      np.float32)


def _state(opt):
    return {k: v for k, v in opt.state_dict().items() if k != "LR_Scheduler"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case):
    params, grads = _data()
    ref_ps, ref_opt = _ref_run(case, params, grads)
    ps, opt = _port_run(case, params, grads)
    if CASES[case][4]:  # multi_precision: the masters, then the rounding
        for i in range(len(ps)):
            np.testing.assert_allclose(
                _np(opt._master[i]), np.asarray(ref_opt._master[i]),
                rtol=RTOL, atol=ATOL, err_msg=f"master {i}")
            np.testing.assert_array_equal(
                _np(ps[i]), np.asarray(raw(ref_ps[i]), np.float32))
    else:
        for i, (a, b) in enumerate(zip(ps, ref_ps)):
            np.testing.assert_allclose(_np(a), np.asarray(raw(b)),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"param {i}")
    ref_state, state = _state(ref_opt), _state(opt)
    assert sorted(state) == sorted(ref_state)
    for k in state:
        np.testing.assert_allclose(_np(state[k]), _np(ref_state[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("case", ["adagrad-l2-norm", "asgd",
                                  "rprop-value-sched",
                                  "nadam-l1-sched", "radam",
                                  "lamb-exclude-global-sched",
                                  "lars-exclude-norm"])
def test_state_dict_round_trip(case, tmp_path):
    """Two steps, ``state_dict`` through ``paddle.save`` / ``load`` into a
    fresh optimizer over copies of the parameters, three more steps: the
    same as five steps in one run. (f32 parameters: under
    ``multi_precision`` the masters are not saved, as the reference's, so
    a reload starts them again from the rounded parameters.)"""
    params, grads = _data(1)
    mp = CASES[case][4]
    ps = _port_params(params, mp)
    opt, sched = _make(tp, case, ps)
    _port_steps(opt, sched, ps, grads[:2], mp)
    tp.save(opt.state_dict(), str(tmp_path / "o.pdopt"))
    ps2 = _port_params([_np(p) for p in ps], mp)
    opt2, sched2 = _make(tp, case, ps2)
    opt2.set_state_dict(tp.load(str(tmp_path / "o.pdopt"), device="cpu"))
    if sched2 is not None:
        assert sched2.last_epoch == sched.last_epoch
    _port_steps(opt2, sched2, ps2, grads[2:], mp)
    _port_steps(opt, sched, ps, grads[2:], mp)
    for a, b in zip(ps, ps2):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    assert sorted(_state(opt2)) == sorted(_state(opt))


def test_named_state_keys_and_exclusion_fire():
    """Named parameters key the state by name on both sides; Lamb's
    exclusion drops the decay of the bias only (its moments stay those of
    the others' rule), Lars's keeps the bias's trust ratio."""
    params, grads = _data(2)
    for case, marker in (("lamb-exclude-global-sched", "wd_excluded"),
                         ("lars-exclude-norm", "excluded")):
        ref_ps, ref_opt = _ref_run(case, params, grads, steps=1)
        ps = _port_params(params, False)
        opt, sched = _make(tp, case, ps)
        _port_steps(opt, sched, ps, grads[:1], False)
        keys = sorted(_state(opt))
        assert keys == sorted(_state(ref_opt))
        assert f"linear_0.b_0.{marker}" in keys
        assert not any(k.startswith("param_") for k in keys)
        assert not any(k.startswith(f"{n}.{marker}")
                       for n in NAMES if "b_" not in n for k in keys)
    # without the exclusion the bias decays: its update differs
    ps_a = _port_params(params, False)
    ps_b = _port_params(params, False)
    a = topt.Lamb(LR, lamb_weight_decay=0.5, parameters=ps_a,
                  exclude_from_weight_decay_fn=_excl_bias)
    b = topt.Lamb(LR, lamb_weight_decay=0.5, parameters=ps_b)
    _port_steps(a, None, ps_a, grads[:1], False)
    _port_steps(b, None, ps_b, grads[:1], False)
    assert not torch.equal(ps_a[1], ps_b[1])
    torch.testing.assert_close(ps_a[0], ps_b[0], rtol=0, atol=0)


@pytest.fixture
def on_cpu():
    """The port's default device set to the CPU, restored after."""
    from paddle_tpu_torch import device as tdevice

    prev = tdevice._default
    tp.set_device("cpu")
    yield
    tdevice._default = prev


def test_named_linear_adamw_state_keys_match_reference(on_cpu, tmp_path):
    """A ``Linear`` made with named ``ParamAttr`` s: its AdamW
    ``state_dict`` has the reference's keys (by name), an unnamed one keeps
    ``param_{i}``; a named parameter's name survives ``paddle.save`` /
    ``paddle.load`` on both sides."""
    x = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    out = {}
    for pkg in (paddle, tp):
        lin = pkg.nn.Linear(6, 3,
                            weight_attr=pkg.nn.ParamAttr(name="fc.w"),
                            bias_attr=pkg.nn.ParamAttr(name="fc.b"))
        plain = pkg.nn.Linear(6, 3)
        opt = pkg.optimizer.AdamW(
            0.01, parameters=list(lin.parameters())
            + list(plain.parameters()))
        xt = pkg.to_tensor(x)
        loss = (lin(xt) ** 2).mean() + (plain(xt) ** 2).mean()
        loss.backward()
        opt.step()
        path = str(tmp_path / f"{pkg.__name__}.pdparams")
        pkg.save({"w": lin.weight}, path)
        loaded = pkg.load(path)["w"]
        out[pkg.__name__] = (sorted(opt.state_dict()), lin.weight.name,
                             loaded.name, plain.weight.name)
    ref, port = out["paddle_tpu"], out["paddle_tpu_torch"]
    assert port == ref
    assert "fc.w.moment1" in port[0] and "param_2.moment1" in port[0]
    assert port[1:] == ("fc.w", "fc.w", None)


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_lbfgs_trajectory_matches_reference(problem, on_cpu):
    """Five ``step(closure)`` s from one start: the reference's procedure
    (two-loop direction, Armijo backtracking from ``learning_rate``)."""
    rng = np.random.default_rng(4)
    if problem == "quadratic":
        a = rng.standard_normal((5, 5)).astype(np.float32)
        a = (a @ a.T + 5 * np.eye(5)).astype(np.float32)
        b = rng.standard_normal(5).astype(np.float32)
        x0 = rng.standard_normal(5).astype(np.float32)

        def f(pkg, x):
            A, B = pkg.to_tensor(a), pkg.to_tensor(b)
            return 0.5 * (x * pkg.matmul(A, x)).sum() - (B * x).sum()
    else:
        x0 = np.array([-1.2, 1.0], np.float32)

        def f(pkg, x):
            return (100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2)

    def run(pkg, param):
        opt = pkg.optimizer.LBFGS(learning_rate=1.0, history_size=4,
                                  parameters=[param])

        def closure():
            opt.clear_grad()
            loss = f(pkg, param)
            loss.backward()
            return loss

        traj = []
        for _ in range(5):
            opt.step(closure)
            traj.append(_np(param).copy() if pkg is tp
                        else np.asarray(raw(param)).copy())
        return np.stack(traj)

    ref = run(paddle, RefParameter(jnp.asarray(x0)))
    port = run(tp, PortParameter(torch.from_numpy(x0.copy())))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(port[-1] - port[0]).max() > 0


def _linear_named_bias(seed=0):
    torch.manual_seed(seed)
    layer = tp.nn.Linear(6, 4, device="cpu")
    layer.bias.name = "b_0"  # the exclusion matches on the name
    return layer


def test_lars_trust_ratio_and_exclusion_numpy_replay():
    """The reference's own case (``tests/test_optimizer.py``) on the port:
    four Lars steps against a numpy replay; the excluded bias zeroes the
    decay only."""
    layer = _linear_named_bias()
    lr, mu, coeff, wd = 0.1, 0.9, 0.001, 0.0005
    opt = topt.Lars(learning_rate=lr, momentum=mu, lars_coeff=coeff,
                    lars_weight_decay=wd, parameters=layer.parameters(),
                    exclude_from_weight_decay=["b_"])
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((5, 6)).astype("float32"))
    ws = [p.detach().numpy().copy() for p in layer.parameters()]
    vs = [np.zeros_like(w) for w in ws]
    excl = [any(s in (p.name or "") for s in ["b_"])
            for p in layer.parameters()]
    for _ in range(4):
        loss = (layer(x) ** 2).mean()
        loss.backward()
        gs = [p.grad.numpy().copy() for p in layer.parameters()]
        opt.step()
        opt.clear_grad()
        for i, (w, v, g) in enumerate(zip(ws, vs, gs)):
            wd_i = 0.0 if excl[i] else wd
            p_n, g_n = np.linalg.norm(w), np.linalg.norm(g)
            denom = g_n + wd_i * p_n
            local = lr * coeff * p_n / denom if (p_n > 0 and denom > 0) \
                else lr
            v = mu * v + local * (g + wd_i * w)
            ws[i], vs[i] = w - v, v
        for p, w in zip(layer.parameters(), ws):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5,
                                       atol=1e-6)
    assert any(excl)


def test_lars_under_train_step():
    """The reference's second case: Lars with its exclusion marker through
    ``TrainStep``; the loss falls."""
    from paddle_tpu_torch.jit import TrainStep

    layer = _linear_named_bias(1)
    opt = topt.Lars(learning_rate=0.05, parameters=layer.parameters(),
                    exclude_from_weight_decay=["b_"])
    step = TrainStep(layer, lambda m, x: (m(x) ** 2).mean(), opt)
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((5, 6)).astype("float32"))
    losses = [float(step(x)) for _ in range(5)]
    assert losses[-1] < losses[0], losses


def test_public_names_match_reference():
    ref = {n for n, v in vars(paddle.optimizer).items()
           if isinstance(v, type) and v.__module__ == "paddle_tpu.optimizer"}
    assert ref <= set(topt.__all__)
    for name in ref - {"Optimizer"}:
        cls = getattr(topt, name)
        assert not issubclass(cls, torch.optim.Optimizer), name
