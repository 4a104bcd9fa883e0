"""``multi_precision`` of the port's AdamW against the reference's
functional update (the path ``TrainStep`` runs): bf16 parameters, gradients
made with numpy from a seed, three steps on both sides. With the flag the
moments are f32 and the rule runs in f32, the parameter written back in
bf16; without it the moments stay bf16."""
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
    vals = [jnp.asarray(p, jnp.bfloat16) for p in params]
    states = opt.functional_states()
    for gs in grads:
        vals, states = opt.functional_update(
            vals, [jnp.asarray(g) for g in gs], states, LR)
    return vals, states


def _port(params, grads, multi_precision):
    ps = [torch.nn.Parameter(torch.from_numpy(p).bfloat16()) for p in params]
    opt = topt.AdamW(parameters=ps, **_kw(multi_precision))
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).bfloat16()
        opt.step()
        opt.clear_grad()
    return ps, opt._accumulators


@pytest.mark.parametrize("multi_precision", [True, False])
def test_adamw_bf16_trajectory_matches_functional_update(multi_precision):
    params, grads = _data()
    want, ref_states = _reference(params, grads, multi_precision)
    got, states = _port(params, grads, multi_precision)
    moment = torch.float32 if multi_precision else torch.bfloat16
    for p0, p, w, st, rst in zip(params, got, want, states, ref_states):
        assert p.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
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
