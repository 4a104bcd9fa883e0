"""``multi_precision`` of the port's AdamW against the reference's
functional update: bf16 parameters, gradients made with numpy from a seed,
three steps on both sides. With the flag the port keeps an f32 master and
f32 moments, as the reference's eager ``step`` does under
``_use_master_weights``; that step is the functional update run on the f32
master with the gradient read as f32, which is what the reference side
runs here, and the port's bf16 parameter is its master rounded. Without
the flag the moments stay bf16 and the update is the functional one on
the bf16 parameters (the path ``TrainStep`` runs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.layer import Parameter
from paddle_tpu_torch import optimizer as topt

LR = 1e-2
STEPS = 3
SHAPES = ((64, 48), (48,))
# Both sides round the terms (1 - beta) * g to bf16 before the f32 sums,
# the reference with (1 - beta) itself rounded to bf16 first (jnp's
# promotion of a Python scalar): the moments differ by a few bf16 roundings
# of their terms, measured up to 0.9 % of max|moment|.
MOMENT_TOL = 2 ** -6
# Adam moves a parameter by lr * mhat / sqrt(vhat), so that difference in
# mhat moves it by a small fraction of lr (measured up to 0.07 lr beyond
# one bf16 ulp over the three steps)
PARAM_SLACK = 0.1


def _bf16_ulp(x):
    """The spacing of bf16 numbers at each element of ``x`` (f32)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _kw(multi_precision):
    return dict(learning_rate=LR, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, multi_precision=multi_precision)


def _reference(params, grads, multi_precision):
    ps = [Parameter(jnp.asarray(p, jnp.bfloat16)) for p in params]
    opt = paddle.optimizer.AdamW(parameters=ps, **_kw(multi_precision))
    # with the flag, the f32 masters of the bf16 parameters, and the bf16
    # gradients read as f32 (the eager step's master arithmetic)
    dt = jnp.float32 if multi_precision else jnp.bfloat16
    vals = [jnp.asarray(p, jnp.bfloat16).astype(dt) for p in params]
    states = opt.functional_states()
    for gs in grads:
        vals, states = opt.functional_update(
            vals, [jnp.asarray(g, jnp.bfloat16).astype(dt) for g in gs],
            states, LR)
    return vals, states


def _port(params, grads, multi_precision):
    ps = [torch.nn.Parameter(torch.from_numpy(p).bfloat16()) for p in params]
    opt = topt.AdamW(parameters=ps, **_kw(multi_precision))
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).bfloat16()
        opt.step()
        opt.clear_grad()
    return ps, opt._accumulators, opt._master


@pytest.mark.parametrize("multi_precision", [True, False])
def test_adamw_bf16_trajectory_matches_functional_update(multi_precision):
    params, grads = _data()
    want, ref_states = _reference(params, grads, multi_precision)
    got, states, masters = _port(params, grads, multi_precision)
    moment = torch.float32 if multi_precision else torch.bfloat16
    assert sorted(masters) == ([0, 1] if multi_precision else [])
    for i, (p0, p, w, st, rst) in enumerate(
            zip(params, got, want, states, ref_states)):
        assert p.dtype == torch.bfloat16
        assert w.dtype == (jnp.float32 if multi_precision else jnp.bfloat16)
        if multi_precision:
            # the master is the reference's f32 trajectory (f32 roundings
            # ordered alike) and the parameter is the master rounded
            m = masters[i]
            assert m.dtype == torch.float32
            np.testing.assert_allclose(m.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6 * LR)
            assert torch.equal(p, m.bfloat16())
        for k in ("moment1", "moment2"):
            assert st[k].dtype == moment, k
            assert str(rst[k].dtype) == str(moment)[6:], k
            ref = np.asarray(rst[k], np.float32)
            np.testing.assert_allclose(st[k].float().numpy(), ref, rtol=0,
                                       atol=MOMENT_TOL * np.abs(ref).max())
        got_f = p.detach().float().numpy()
        want_f = np.asarray(w, np.float32)
        start = torch.from_numpy(p0).bfloat16().float().numpy()
        # the three steps moved the parameters by bf16 ulps ...
        assert (got_f != start).mean() > 0.5
        # ... and both sides agree within one bf16 rounding and the slack
        assert np.all(np.abs(got_f - want_f)
                      <= _bf16_ulp(want_f) + PARAM_SLACK * LR)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_clip_scales_in_place_as_the_reference(dtype):
    """The clip scales each gradient in place (no copy beside it) to the
    reference's values: the same f32 norm, each gradient rounded to its
    dtype after the product."""
    _, grads = _data(seed=5)
    gs = [torch.from_numpy(g * 3).to(getattr(torch, dtype))
          for g in grads[0]]
    want = paddle.nn.ClipGradByGlobalNorm(1.0)(
        [(None, jnp.asarray(g.float().numpy(), dtype)) for g in gs])
    ptrs = [g.data_ptr() for g in gs]
    got = topt.ClipGradByGlobalNorm(1.0)([(None, g) for g in gs])
    assert [g.data_ptr() for _, g in got] == ptrs
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-6,
                                   atol=0)
