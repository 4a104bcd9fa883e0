"""Activation recompute of the PyTorch port
(``distributed/fleet/utils/recompute_helper.py``) and the configuration
fields that turn it on, against the reference, on the tiny GPT and Llama of
``torch_port_utils`` (2 layers, Llama at G = 2).

Gradients with recompute must equal the port's own run without it
exactly (the backward recomputes the same CPU ops on the same inputs),
also when ``auto_cast`` is entered inside the loss and the backward runs
outside it; and they must equal the reference's recompute run within f32
tolerance. The flash kernel K1 is no matrix product, so it runs again in
the backward under every granularity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.text.models import gpt as ref_gpt
from paddle_tpu.text.models import llama as ref_llama
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet.utils import (
    policy_for_granularity, recompute)
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text.models import gpt as tgpt
from paddle_tpu_torch.text.models import llama as tllama

from torch_port_utils import (VOCAB, no_mesh, numpy_state, tiny_gpt_kwargs,
                              tiny_llama_kwargs)

# f32 gradients of O(1e-2) through two blocks on both sides: the
# frameworks' matmul / reduction orders differ by ulps (the tolerance of
# tests/test_torch_train.py)
GRAD_TOL = 1e-5
GRANULARITIES = ("full", "full_attn")

MODELS = {
    "gpt": (ref_gpt.GPTConfig, ref_gpt.GPTForCausalLM, tgpt.GPTConfig,
            tgpt.GPTForCausalLM, tiny_gpt_kwargs),
    "llama": (ref_llama.LlamaConfig, ref_llama.LlamaForCausalLM,
              tllama.LlamaConfig, tllama.LlamaForCausalLM,
              tiny_llama_kwargs),
}


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (2, 16))
    labels = rng.integers(0, VOCAB, (2, 16))
    labels[1, :3] = -100
    return ids, labels


def _port(model, state, **cfg):
    _, _, tcfg, tcls, kwargs = MODELS[model]
    tm = tcls(tcfg(**kwargs(), **cfg), device="cpu")
    return tm if state is None else tm.load_numpy_state(state)


@pytest.fixture(scope="module", params=MODELS)
def reference(request):
    """(model name, reference state, reference gradients by granularity)."""
    rcfg, rcls, _, _, kwargs = MODELS[request.param]
    ids, labels = _batch()
    grads, state = {}, None
    with no_mesh():
        for gran in GRANULARITIES:
            paddle.seed(7)
            jm = rcls(rcfg(**kwargs(), use_recompute=True,
                           recompute_granularity=gran))
            jm.eval()
            if state is None:
                state = numpy_state(jm)
            jm(Tensor(jnp.asarray(ids)),
               labels=Tensor(jnp.asarray(labels))).backward()
            grads[gran] = {n: np.asarray(raw(p.grad))
                           for n, p in jm.named_parameters()}
    yield request.param, state, grads


def _loss_grads(tm, level=None):
    ids, labels = _batch()
    if level is None:
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    else:  # AMP inside the loss; the backward below runs outside it
        with amp.auto_cast(level=level):
            loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("level", [None, "O1"], ids=["f32", "O1"])
@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_recompute_grads_equal_the_run_without(reference, granularity,
                                               level):
    model, state, _ = reference
    plain = _port(model, state)
    loss0, want = _loss_grads(plain, level)
    tm = _port(model, state, use_recompute=True,
               recompute_granularity=granularity)
    loss, got = _loss_grads(tm, level)
    assert torch.equal(loss, loss0)
    for n, g in want.items():
        assert torch.equal(got[n], g), n


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_recompute_grads_match_reference(reference, granularity):
    model, state, ref_grads = reference
    tm = _port(model, state, use_recompute=True,
               recompute_granularity=granularity)
    _, got = _loss_grads(tm)
    want = ref_grads[granularity]
    assert sorted(got) == sorted(want)
    scale = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        err = np.abs(got[n].numpy() - g).max()
        assert err <= GRAD_TOL * scale, (n, err)


@pytest.fixture
def counted_kernels(monkeypatch):
    """The flash route with the kernels' plain versions standing in for the
    kernels and counting as they do."""
    monkeypatch.setattr(fa, "_is_cuda", lambda q: True)
    for name, counter in (("forward", "launches_fwd"),
                          ("bwd_dq", "launches_dq"),
                          ("bwd_dkv", "launches_dkv")):
        plain = getattr(fa, f"flash_attention_{name}_plain")

        def launch(*a, _plain=plain, _counter=counter, **k):
            setattr(fa, _counter, getattr(fa, _counter) + 1)
            return _plain(*a, **k)

        monkeypatch.setattr(fa, f"flash_attention_{name}_cuda", launch)
        monkeypatch.setattr(fa, counter, 0)
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU", True)


@pytest.mark.parametrize("use_recompute", [False, True])
@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_k1_runs_again_in_the_backward(reference, granularity,
                                       use_recompute, counted_kernels):
    model, state, _ = reference
    tm = _port(model, state, use_recompute=use_recompute,
               recompute_granularity=granularity)
    layers = tm.config.num_hidden_layers
    _loss_grads(tm)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == (
        (2 if use_recompute else 1) * layers, layers, layers)


def test_gpt_without_flash_takes_the_dense_attention(counted_kernels):
    """``GPTConfig(use_flash_attention=False)`` launches no flash kernel
    (the flash route is open to CPU tensors here), and its loss and
    gradients equal the flash route's on the same weights within the f32
    tolerance of the reference comparison above."""
    loss, got = _loss_grads(_port("gpt", None, use_flash_attention=False))
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == (0, 0, 0)
    want_loss, want = _loss_grads(_port("gpt", None))
    layers = tiny_gpt_kwargs()["num_hidden_layers"]
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == (
        layers, layers, layers)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= GRAD_TOL * scale, (n, err)


def test_policy_for_granularity():
    assert policy_for_granularity("full") is None
    assert policy_for_granularity(None) is None
    mm = torch.ops.aten.mm.default
    for g in ("full_attn", "core_attn", "dots"):
        assert mm in policy_for_granularity(g)
    with pytest.raises(ValueError, match="granularity"):
        policy_for_granularity("selective")


def test_recompute_function_and_policy_win():
    """The bare API: keyword arguments reach the function; an explicit
    policy wins over the granularity; the result and gradient are the
    plain ones."""
    w = torch.randn(4, 4, dtype=torch.float64, requires_grad=True)
    x = torch.randn(3, 4, dtype=torch.float64)

    def f(a, scale=1.0):
        return torch.tanh(a @ w) * scale

    want = torch.autograd.grad(f(x, scale=2.0).sum(), w)[0]
    mm = torch.ops.aten.mm.default
    for kw in (dict(granularity="full"),
               dict(policy=[mm], granularity="bogus")):
        got = torch.autograd.grad(recompute(f, x, scale=2.0, **kw).sum(), w)
        assert torch.equal(got[0], want)


@pytest.mark.parametrize("model", MODELS)
def test_config_accepts_the_reference_fields(model):
    rcfg, _, tcfg, _, kwargs = MODELS[model]
    fields = dict(use_recompute=True, recompute_granularity="core_attn",
                  use_flash_attention=False, sequence_parallel=False,
                  fold_layers=False)
    got, want = tcfg(**kwargs(), **fields), rcfg(**kwargs(), **fields)
    for k in fields:
        assert getattr(got, k) == getattr(want, k), k
    # sequence parallelism is ported (a no-op at mp degree 1, as in the
    # reference); so is fold_layers (tests/test_torch_fold_layers.py)
    assert tcfg(**kwargs(), sequence_parallel=True).sequence_parallel
    assert tcfg(**kwargs(), fold_layers=True).fold_layers
    with pytest.raises(ValueError, match="granularity"):
        _port(model, None, use_recompute=True,
              recompute_granularity="selective")(
            torch.zeros((1, 4), dtype=torch.int64))
