"""Learning-rate schedulers of the PyTorch port (``optimizer/lr.py``)
against the reference's ``paddle_tpu.optimizer.lr``: every scheduler's
learning rate over 20 steps and its state, the optimizer's scheduler API
and ``state_dict``, and a 3-step ``TrainStep`` + ``AdamW`` trajectory under
``LinearWarmup(CosineAnnealingDecay)`` on the tiny GPT of
``torch_port_utils`` against the reference's ``TrainStep``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.nn.layer import Parameter
from paddle_tpu.optimizer import lr as ref_lr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import lr as tlr

from torch_port_utils import VOCAB, jax_tiny_gpt, numpy_state, torch_tiny_gpt

STEPS = 20
# the tolerances of tests/test_torch_train.py's trajectory, for the same
# reasons (f32 through two blocks; Adam's sign-like steps on noise)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
TRAIN_STEPS = 3
PEAK_LR = 1e-3
NOISE_BOUND = 2 * PEAK_LR * TRAIN_STEPS
MAX_NOISY_FRACTION = 0.01


def _halve(epoch):
    return 0.5 ** (epoch % 3)


# name -> keyword arguments, the same on both sides
SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=2.0),
    "PiecewiseDecay": dict(boundaries=[3, 8, 15], values=[1.0, 0.5, 0.1,
                                                          0.01]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.3),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=7, end_lr=0.01,
                            power=2.0, cycle=True),
    "LinearWarmup": dict(learning_rate=0.3, warmup_steps=6, start_lr=0.0,
                         end_lr=0.3),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[4, 9, 13],
                           gamma=0.3),
    "StepDecay": dict(learning_rate=0.5, step_size=4, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=12, eta_min=0.01),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=4, T_mult=2,
                                        eta_min=0.02),
    "OneCycleLR": dict(max_learning_rate=0.8, total_steps=16),
    "CyclicLR": dict(base_learning_rate=0.1, max_learning_rate=0.9,
                     step_size_up=3, step_size_down=5, mode="triangular2"),
    "ReduceOnPlateau": dict(learning_rate=0.5, patience=1, cooldown=1,
                            factor=0.5),
    "MultiplicativeDecay": dict(learning_rate=0.5, lr_lambda=_halve),
    "LinearLR": dict(learning_rate=0.5, total_steps=9, start_factor=0.2),
}
# a loss that stalls, for ReduceOnPlateau
METRICS = [5.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.0] * 2


def _trace(module, name):
    kw = SCHEDULERS[name]
    s = getattr(module, name)(**kw)
    lrs = [s()]
    for i in range(STEPS):
        if name == "ReduceOnPlateau":
            s.step(METRICS[i])
        else:
            s.step()
        lrs.append(s())
    return lrs, s.state_dict()


@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_matches_reference(name):
    got, got_state = _trace(tlr, name)
    want, want_state = _trace(ref_lr, name)
    assert got == want
    assert got_state == want_state
    assert len(set(got)) > 1  # the schedule moved


def test_every_reference_scheduler_is_ported():
    ref = {n for n, c in vars(ref_lr).items()
           if isinstance(c, type) and issubclass(c, ref_lr.LRScheduler)}
    assert ref - {"LRScheduler"} == set(SCHEDULERS)
    assert all(issubclass(getattr(tlr, n), tlr.LRScheduler)
               for n in SCHEDULERS)


def test_warmup_wrapping_cosine_and_state_round_trip():
    def make(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(0.4, T_max=10),
                              warmup_steps=3, start_lr=0.0, end_lr=0.4)

    a, b = make(tlr), make(ref_lr)
    for _ in range(7):
        a.step()
        b.step()
        assert a() == b()
    c = make(tlr)
    c.set_state_dict(a.state_dict())
    a.step()
    c.step()
    assert c() == a() and c.last_epoch == 8


def test_optimizer_takes_a_scheduler():
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.5, step_size=2, gamma=0.5)
    opt = topt.AdamW(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.5
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    p.grad = torch.ones(3)
    opt.step()
    sched.step()
    sched.step()
    assert opt.get_lr() == 0.25
    state = opt.state_dict()
    assert state["LR_Scheduler"] == sched.state_dict()
    assert sorted(state) == ["LR_Scheduler", "param_0.beta1_pow",
                             "param_0.beta2_pow", "param_0.moment1",
                             "param_0.moment2"]
    # the reference's optimizer holds the same scheduler state
    ref_sched = ref_lr.StepDecay(0.5, step_size=2, gamma=0.5)
    ref_sched.step()
    ref_sched.step()
    ref_opt = paddle.optimizer.AdamW(learning_rate=ref_sched,
                                     parameters=[Parameter(jnp.ones(3))])
    assert ref_opt.state_dict()["LR_Scheduler"] == state["LR_Scheduler"]
    # a fresh optimizer and scheduler take the state back
    q = torch.nn.Parameter(torch.ones(3))
    other = topt.AdamW(
        learning_rate=tlr.StepDecay(0.5, step_size=2, gamma=0.5),
        parameters=[q])
    other.set_state_dict(state)
    assert other.get_lr() == 0.25
    assert torch.equal(other._accumulators[0]["moment1"],
                       opt._accumulators[0]["moment1"])
    other.set_lr_scheduler(tlr.ExponentialDecay(0.1, gamma=0.5))
    assert other.get_lr() == 0.1
    plain = topt.Adam(learning_rate=0.1, parameters=[q])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2 and "LR_Scheduler" not in plain.state_dict()


def _schedule(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(PEAK_LR, T_max=20,
                                                 eta_min=1e-4),
                          warmup_steps=2, start_lr=1e-4, end_lr=PEAK_LR)


def _adamw(params, module, sched):
    return module.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                        epsilon=1e-8, weight_decay=0.1, parameters=params,
                        grad_clip=module.ClipGradByGlobalNorm(1.0))


def _batch():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, VOCAB, (2, 16))
    labels = rng.integers(0, VOCAB, (2, 16))
    return ids, labels


def test_trainstep_trajectory_with_warmup_cosine_matches_reference():
    ids, labels = _batch()
    with jax_tiny_gpt() as jm:
        state = numpy_state(jm)
        sched = _schedule(ref_lr)
        step = RefTrainStep(jm, lambda m, i, l: m(i, labels=l),
                            _adamw(jm.parameters(), paddle.optimizer, sched))
        want_losses, want_lrs = [], []
        for _ in range(TRAIN_STEPS):
            want_lrs.append(sched())
            want_losses.append(float(np.asarray(raw(step(
                Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(labels)))))))
            sched.step()
        want = {n: np.asarray(raw(p)) for n, p in jm.named_parameters()}
    tm = torch_tiny_gpt(state)
    sched = _schedule(tlr)
    opt = _adamw(tm.parameters(), topt, sched)
    step = TrainStep(tm, lambda m, i, l: m(i, labels=l), opt)
    losses, lrs = [], []
    for _ in range(TRAIN_STEPS):
        lrs.append(opt.get_lr())
        losses.append(float(step(torch.from_numpy(ids),
                                 torch.from_numpy(labels))))
        sched.step()
    assert lrs == want_lrs and len(set(lrs)) == TRAIN_STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    noisy = total = 0
    for n, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[n])
        assert d.max() <= NOISE_BOUND, (n, d.max())
        noisy += int((d > PARAM_ATOL).sum())
        total += d.size
    assert noisy <= MAX_NOISY_FRACTION * total, (noisy, total)


def test_adamw_forms_its_step_in_f32_as_the_reference():
    """One AdamW step at a learning rate that f32 cannot hold exactly: the
    port rounds it to f32 and forms ``1 - lr * wd`` in f32, as the
    reference's functional update does with ``TrainStep``'s f32 lr."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    g = rng.standard_normal((64, 32)).astype(np.float32)
    lr = 1e-3 / 3
    ref = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.3,
                                 parameters=[Parameter(jnp.asarray(w))])
    (want,), _ = ref.functional_update(
        [jnp.asarray(w)], [jnp.asarray(g)], ref.functional_states(),
        jnp.asarray(lr, jnp.float32))
    p = torch.nn.Parameter(torch.from_numpy(w))
    opt = topt.AdamW(learning_rate=lr, weight_decay=0.3, parameters=[p])
    p.grad = torch.from_numpy(g)
    opt.step()
    # the same f32 operations; XLA may fuse them, so allow one ulp
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                               rtol=2 ** -23, atol=0)
