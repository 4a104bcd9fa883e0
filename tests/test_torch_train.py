"""Training path of the PyTorch port against the reference, on the tiny
GPT of ``torch_port_utils`` with bridged weights: the LM loss, per-
parameter gradients (through ``FlashAttentionFunction``'s plain route and
through ``_sdpa_reference``) and a 3-step ``TrainStep`` + ``AdamW``
trajectory."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.nn.functional.loss import _parallel_softmax_ce
from paddle_tpu_torch.ops import flash_attention as fa

from torch_port_utils import VOCAB, jax_tiny_gpt, numpy_state, torch_tiny_gpt

# f32 loss through two blocks, the tied head and the CE on both sides:
# matmul / reduction orders differ by ulps
LOSS_RTOL = 1e-5
# f32 gradients of O(1e-2): a few ulps of the largest, relative to it
GRAD_TOL = 1e-5
LR = 1e-3
STEPS = 3
# Adam moves an element by about lr * sign(g) whenever |g| >> eps, so an
# element whose gradient is float noise on both sides (e.g. the key bias,
# whose exact gradient is 0: softmax ignores a per-row constant) can
# drift apart by up to 2 * lr per step; every element must stay within
# that bound, and all but a few within PARAM_ATOL
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * LR * STEPS
MAX_NOISY_FRACTION = 0.01


def _batch(t=24, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (2, t))
    labels = rng.integers(0, VOCAB, (2, t))
    labels[0, :5] = -100                      # ignore_index rows
    mask = (rng.random((2, t)) > 0.3).astype(np.float32)
    return ids, labels, mask


@pytest.fixture(scope="module")
def bridged():
    with jax_tiny_gpt() as jm:
        yield jm, numpy_state(jm)


@pytest.fixture(params=["sdpa_reference", "flash_plain"])
def route(request, monkeypatch):
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU",
                        request.param == "flash_plain")
    return request.param


def _ref_loss(jm, ids, labels, mask=None):
    return jm(Tensor(jnp.asarray(ids)), labels=Tensor(jnp.asarray(labels)),
              loss_mask=None if mask is None else Tensor(jnp.asarray(mask)))


@pytest.mark.parametrize("with_mask", [False, True])
def test_loss_matches_reference(bridged, with_mask):
    jm, state = bridged
    tm = torch_tiny_gpt(state)
    ids, labels, mask = _batch()
    m = mask if with_mask else None
    want = float(np.asarray(raw(_ref_loss(jm, ids, labels, m))))
    with torch.no_grad():
        got = float(tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                       loss_mask=None if m is None else torch.from_numpy(m)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_parallel_softmax_ce_matches_reference():
    from paddle_tpu.distributed.fleet.layers.mpu import (
        _parallel_softmax_ce as ref_ce)

    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    labels[1, 2] = -100
    want = np.asarray(raw(ref_ce(jnp.asarray(logits), jnp.asarray(labels),
                                 -100)))
    got = _parallel_softmax_ce(torch.from_numpy(logits),
                               torch.from_numpy(labels), -100)
    assert got[1, 2] == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_grads_match_reference(bridged, route):
    jm, state = bridged
    tm = torch_tiny_gpt(state)
    ids, labels, mask = _batch(seed=4)
    loss = _ref_loss(jm, ids, labels, mask)
    loss.backward()
    want = {n: np.asarray(raw(p.grad)) for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_grad()
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
       loss_mask=torch.from_numpy(mask)).backward()
    # the CPU route runs the kernels' plain versions: nothing launches
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    scale = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        err = np.abs(named[n].grad.numpy() - g).max()
        assert err <= GRAD_TOL * scale, (route, n, err)


def test_sdpa_flash_route_is_taken_on_cpu_only_through_the_hook(monkeypatch):
    calls = []
    real = fa.FlashAttentionFunction.apply
    monkeypatch.setattr(fa.FlashAttentionFunction, "apply",
                        lambda *a: (calls.append(1), real(*a))[1])
    x = torch.randn((1, 8, 2, 16))
    tattn.scaled_dot_product_attention(x, x, x, is_causal=True)
    assert calls == []
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU", True)
    tattn.scaled_dot_product_attention(x, x, x, is_causal=True)
    assert calls == [1]
    # active dropout keeps the dense route, as in the reference
    tattn.scaled_dot_product_attention(x, x, x, dropout_p=0.5)
    assert calls == [1]


def test_optimizer_trains_reference_parameter_order(bridged):
    jm, state = bridged
    tm = torch_tiny_gpt(state)
    ref_opt = paddle.optimizer.AdamW(parameters=jm.parameters())
    ref_names = {id(p): n for n, p in jm.named_parameters()}
    opt = topt.AdamW(parameters=tm.parameters())
    names = {id(p): n for n, p in tm.named_parameters()}
    got = [names[id(p)] for p in opt._parameter_list]
    assert got == [ref_names[id(p)] for p in ref_opt._parameter_list]
    assert got.count("gpt.embeddings.word_embeddings.weight") == 1
    assert len(got) == len(set(got)) == len(state)


def _adamw(params, opt_mod, clip):
    return opt_mod.AdamW(learning_rate=LR, beta1=0.9, beta2=0.95,
                         epsilon=1e-8, parameters=params, weight_decay=0.1,
                         grad_clip=clip(1.0))


@pytest.fixture(scope="module")
def reference_trajectory():
    ids, labels, _ = _batch(seed=5)
    with jax_tiny_gpt(seed=11) as jm:
        state = numpy_state(jm)
        opt = _adamw(jm.parameters(), paddle.optimizer,
                     paddle.nn.ClipGradByGlobalNorm)
        step = RefTrainStep(jm, lambda m, i, l: m(i, labels=l), opt)
        losses = [float(np.asarray(raw(step(Tensor(jnp.asarray(ids)),
                                            Tensor(jnp.asarray(labels))))))
                  for _ in range(STEPS)]
        final = {n: np.asarray(raw(p)) for n, p in jm.named_parameters()}
    return state, ids, labels, losses, final


def test_adamw_trajectory_matches_reference(reference_trajectory, route):
    state, ids, labels, want_losses, want = reference_trajectory
    tm = torch_tiny_gpt(state)
    opt = _adamw(tm.parameters(), topt, topt.ClipGradByGlobalNorm)
    step = TrainStep(tm, lambda m, i, l: m(i, labels=l), opt)
    losses = [step(torch.from_numpy(ids), torch.from_numpy(labels))
              for _ in range(STEPS)]
    assert all(x.requires_grad is False for x in losses)
    np.testing.assert_allclose([float(x) for x in losses], want_losses,
                               rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    noisy = total = 0
    for n, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[n])
        assert d.max() <= NOISE_BOUND, (route, n, d.max())
        noisy += int((d > PARAM_ATOL).sum())
        total += d.size
    assert noisy <= MAX_NOISY_FRACTION * total, (route, noisy, total)
    # state on the parameters' device, beta powers as f32 scalars
    st = opt._accumulators[0]
    assert st["beta1_pow"].dtype == torch.float32
    np.testing.assert_allclose(float(st["beta1_pow"]), 0.9 ** STEPS,
                               rtol=1e-6)


def test_eager_step_matches_train_step(reference_trajectory):
    # the eager loop (backward, step, clear_grad) is TrainStep's update:
    # same ops in the same order, so bit-equal
    state, ids, labels, _, _ = reference_trajectory
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    a, b = torch_tiny_gpt(state), torch_tiny_gpt(state)
    opt_a = _adamw(a.parameters(), topt, topt.ClipGradByGlobalNorm)
    opt_b = _adamw(b.parameters(), topt, topt.ClipGradByGlobalNorm)
    step = TrainStep(a, lambda m, i, l: m(i, labels=l), opt_a)
    for _ in range(2):
        step(ids, labels)
        b(ids, labels=labels).backward()
        opt_b.step()
        opt_b.clear_grad()
    assert all(p.grad is None for p in b.parameters())
    pb = dict(b.named_parameters())
    for n, p in a.named_parameters():
        assert torch.equal(p, pb[n]), n


def test_train_step_trains_only_the_optimizer_parameters():
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    from torch_port_utils import tiny_gpt_kwargs

    tm = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs()), device="cpu", seed=1)
    fixed = tm.gpt.final_layernorm.weight
    before = fixed.detach().clone()
    params = [p for p in tm.parameters() if p is not fixed]
    step = TrainStep(tm, lambda m, i, l: m(i, labels=l),
                     topt.AdamW(learning_rate=LR, parameters=params))
    ids, labels, _ = _batch(seed=6)
    step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert torch.equal(fixed, before) and fixed.grad is None
    assert all(p.grad is None for p in params)
