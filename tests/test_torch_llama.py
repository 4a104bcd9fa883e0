"""Llama of the PyTorch port against the reference on bridged state.

A tiny reference ``LlamaForCausalLM`` (grouped-query attention at G = 2,
and G = 4 where stated) is built in ``paddle_tpu``; its numpy state (the
parameters and each layer's RoPE tables) is loaded into the port's model.
Compared: state names, the RoPE tables and rotations, RMSNorm and the
incubate functionals, logits on both attention routes (the reference's
flash route is its Pallas kernel in interpret mode; the port's is the
plain K1 / K2 through ``FlashAttentionFunction``), the loss, gradients
and a 3-step ``TrainStep`` + ``AdamW`` trajectory.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.incubate import nn as ref_inn
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.nn import functional as ref_F
from paddle_tpu.text.models import llama as ref_llama
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text.models import llama as tllama

from torch_port_utils import (VOCAB, jax_tiny_llama, numpy_state,
                              tiny_llama_kwargs, torch_tiny_llama)

# f32 forward through two blocks and the LM head on both sides: the
# frameworks' matmul / reduction orders differ by ulps
ATOL = 1e-4
# elementwise f32 ops of O(1) values (RoPE, RMSNorm, SwiGLU)
OP_TOL = 1e-6
# the tolerances of tests/test_torch_train.py, for the same reasons
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
LR = 1e-3
STEPS = 3
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * LR * STEPS
MAX_NOISY_FRACTION = 0.01


def _ref(x):
    return Tensor(jnp.asarray(x))


def _np(x):
    return np.asarray(raw(x))


def _set_route(flash, *models):
    """Both sides' attention route: the flash kernel or dense SDPA over
    repeated kv heads (the reference's ``use_flash`` attribute, as its own
    tests switch it)."""
    for m in models:
        for blk in m.llama.layers:
            blk.self_attn.use_flash = flash


@pytest.fixture(scope="module", params=[(2, False), (2, True), (4, False)],
                ids=["G2", "G2-tied", "G4"])
def bridged(request):
    group, tied = request.param
    with jax_tiny_llama(group=group, tie_word_embeddings=tied) as jm:
        state = numpy_state(jm)
        yield jm, state, torch_tiny_llama(state, group=group,
                                          tie_word_embeddings=tied)


def test_state_names_equal_reference(bridged):
    jm, state, tm = bridged
    ref_state = jm.state_dict()
    assert sorted(tm.state_dict()) == sorted(ref_state)
    # parameters in the reference's order (the optimizer's order)
    assert [n for n, _ in tm.named_parameters()] == [
        n for n, _ in jm.named_parameters()]
    buffers = {n for n, _ in tm.named_buffers()}
    assert buffers == {f"llama.layers.{i}.self_attn.rope_{f}"
                       for i in range(2) for f in ("cos", "sin")}
    assert ("lm_head.weight" in state) != tm.config.tie_word_embeddings
    for name in buffers:
        np.testing.assert_array_equal(tm.state_dict()[name].numpy(),
                                      state[name])


def test_built_rope_buffers_equal_reference():
    """The port builds the tables itself, bit-equal to the reference's
    (no bridge involved)."""
    with jax_tiny_llama() as jm:
        want = numpy_state(jm)
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**tiny_llama_kwargs()),
                                 device="cpu")
    for name, t in tm.named_buffers():
        np.testing.assert_array_equal(t.numpy(), want[name])


@pytest.mark.parametrize("max_t, dim, theta", [(8192, 128, 500000.0),
                                               (64, 8, 10000.0)])
def test_rope_cache_bit_equal(max_t, dim, theta):
    for got, want in zip(tllama._rope_cache(max_t, dim, theta),
                         ref_llama._rope_cache(max_t, dim, theta)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _rope_inputs(seed=0, b=2, t=7, h=3, d=16, max_t=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, d)).astype(np.float32)
    cos, sin = tllama._rope_cache(max_t, d, 500000.0)
    return x, cos, sin


def test_apply_rope_matches_reference():
    x, cos, sin = _rope_inputs()
    want = _np(ref_llama._apply_rope(_ref(x), _ref(cos), _ref(sin)))
    got = tllama._apply_rope(*map(torch.from_numpy, (x, cos, sin)))
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("shape", ["T", "BT"])
def test_apply_rope_positions_matches_reference(shape):
    x, cos, sin = _rope_inputs(seed=1)
    rng = np.random.default_rng(2)
    pos = (rng.integers(0, 64, 7) if shape == "T"
           else rng.integers(0, 64, (2, 7)))
    want = _np(ref_llama._apply_rope_positions(_ref(x), _ref(cos), _ref(sin),
                                               positions=jnp.asarray(pos)))
    got = tllama._apply_rope_positions(
        *map(torch.from_numpy, (x, cos, sin)), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("wshape", [None, (16,), (5, 16)])
def test_rms_norm_matches_reference(wshape):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 16)) * 3).astype(np.float32)
    w = (None if wshape is None
         else rng.standard_normal(wshape).astype(np.float32))
    want = _np(ref_F.rms_norm(_ref(x), None if w is None else _ref(w),
                              epsilon=1e-5))
    got = TF.rms_norm(torch.from_numpy(x),
                      None if w is None else torch.from_numpy(w),
                      epsilon=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=0)


def test_rms_norm_layer_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    ref = paddle.nn.RMSNorm(16, epsilon=1e-5)
    layer = RMSNorm(16, epsilon=1e-5, device="cpu")
    assert torch.equal(layer.weight, torch.ones(16))
    np.testing.assert_array_equal(_np(ref.weight),
                                  layer.weight.detach().numpy())
    w = rng.standard_normal(16).astype(np.float32)
    ref.weight.set_value(w)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    np.testing.assert_allclose(
        layer(torch.from_numpy(x)).detach().numpy(), _np(ref(_ref(x))),
        atol=OP_TOL, rtol=0)


def test_fused_rms_norm_matches_reference():
    rng = np.random.default_rng(5)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 4, 16), (16,), (16,)))
    for bias in (None, b):
        want = _np(ref_inn.fused_rms_norm(
            _ref(x), _ref(w), None if bias is None else _ref(bias), 1e-6))
        got = tinc.fused_rms_norm(
            torch.from_numpy(x), torch.from_numpy(w),
            None if bias is None else torch.from_numpy(bias), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="last-axis"):
        tinc.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            begin_norm_axis=1)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((3, 8)).astype(np.float32) for _ in "xy")
    np.testing.assert_allclose(
        tinc.swiglu(torch.from_numpy(x)).numpy(),
        _np(ref_inn.swiglu(_ref(x))), atol=OP_TOL, rtol=0)
    np.testing.assert_allclose(
        tinc.swiglu(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        _np(ref_inn.swiglu(_ref(x), _ref(y))), atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("tables", ["none", "half", "full", "1T1D"])
def test_fused_rotary_position_embedding_matches_reference(tables):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
               for _ in "qkv")
    cos, sin = tllama._rope_cache(6, 16, 10000.0)
    if tables in ("full", "1T1D"):
        cos, sin = (np.concatenate([c, c], -1) for c in (cos, sin))
    if tables == "1T1D":
        cos, sin = (c[None, :, None, :] for c in (cos, sin))
    kw = {} if tables == "none" else dict(cos=cos, sin=sin)
    want = ref_inn.fused_rotary_position_embedding(
        _ref(q), _ref(k), _ref(v), **{n: _ref(a) for n, a in kw.items()})
    got = tinc.fused_rotary_position_embedding(
        *map(torch.from_numpy, (q, k, v)),
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=OP_TOL, rtol=0)
    only_q = tinc.fused_rotary_position_embedding(torch.from_numpy(q))
    assert only_q[1] is None and only_q[2] is None


def test_fused_rotary_position_embedding_refuses_what_reference_refuses():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="position_ids"):
        tinc.fused_rotary_position_embedding(q, position_ids=torch.arange(4))
    with pytest.raises(NotImplementedError, match="non-neox"):
        tinc.fused_rotary_position_embedding(q, use_neox_rotary_style=False)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("t", [1, 7, 19])
def test_logits_match_reference(bridged, t, flash):
    jm, _, tm = bridged
    _set_route(flash, jm, tm)
    ids = np.random.default_rng(t).integers(0, VOCAB, (2, t))
    ref = _np(jm(_ref(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, t, VOCAB)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_flash_route_runs_the_flash_function(monkeypatch):
    """On CPU tensors the flash route goes through ``FlashAttentionFunction``
    (the plain K1 / K2) with k / v at the kv heads, and launches nothing."""
    calls = []
    real = fa.FlashAttentionFunction.apply

    def spy(q, k, *a):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, *a)

    monkeypatch.setattr(fa.FlashAttentionFunction, "apply", spy)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig(**tiny_llama_kwargs(group=4)), device="cpu")
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    tm(torch.zeros((1, 5), dtype=torch.long),
       labels=torch.zeros((1, 5), dtype=torch.long)).backward()
    assert calls == [(8, 2)] * 2
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before


def _batch(t=24, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (2, t))
    labels = rng.integers(0, VOCAB, (2, t))
    labels[0, :5] = -100                      # ignore_index rows
    mask = (rng.random((2, t)) > 0.3).astype(np.float32)
    return ids, labels, mask


def _ref_loss(jm, ids, labels, mask=None):
    return jm(_ref(ids), labels=_ref(labels),
              loss_mask=None if mask is None else _ref(mask))


@pytest.mark.parametrize("with_mask", [False, True])
def test_loss_matches_reference(bridged, with_mask):
    jm, _, tm = bridged
    _set_route(True, jm, tm)
    ids, labels, mask = _batch()
    m = mask if with_mask else None
    want = float(_np(_ref_loss(jm, ids, labels, m)))
    with torch.no_grad():
        got = float(tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                       loss_mask=None if m is None else torch.from_numpy(m)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_grads_match_reference(flash):
    with jax_tiny_llama(group=4) as jm:
        tm = torch_tiny_llama(numpy_state(jm), group=4)
        _set_route(flash, jm, tm)
        ids, labels, mask = _batch(seed=4)
        _ref_loss(jm, ids, labels, mask).backward()
        want = {n: _np(p.grad) for n, p in jm.named_parameters()}
    tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
       loss_mask=torch.from_numpy(mask)).backward()
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    scale = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        err = np.abs(named[n].grad.numpy() - g).max()
        assert err <= GRAD_TOL * scale, (flash, n, err)


def _adamw(params, opt_mod, clip):
    return opt_mod.AdamW(learning_rate=LR, beta1=0.9, beta2=0.95,
                         epsilon=1e-8, parameters=params, weight_decay=0.1,
                         grad_clip=clip(1.0))


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "dense"])
def reference_trajectory(request):
    flash = request.param
    ids, labels, _ = _batch(seed=5)
    with jax_tiny_llama(seed=11) as jm:
        state = numpy_state(jm)
        _set_route(flash, jm)
        opt = _adamw(jm.parameters(), paddle.optimizer,
                     paddle.nn.ClipGradByGlobalNorm)
        step = RefTrainStep(jm, lambda m, i, l: m(i, labels=l), opt)
        losses = [float(_np(step(_ref(ids), _ref(labels))))
                  for _ in range(STEPS)]
        final = {n: _np(p) for n, p in jm.named_parameters()}
    return flash, state, ids, labels, losses, final


def test_adamw_trajectory_matches_reference(reference_trajectory):
    flash, state, ids, labels, want_losses, want = reference_trajectory
    tm = torch_tiny_llama(state)
    _set_route(flash, tm)
    opt = _adamw(tm.parameters(), topt, topt.ClipGradByGlobalNorm)
    step = TrainStep(tm, lambda m, i, l: m(i, labels=l), opt)
    losses = [step(torch.from_numpy(ids), torch.from_numpy(labels))
              for _ in range(STEPS)]
    np.testing.assert_allclose([float(x) for x in losses], want_losses,
                               rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    noisy = total = 0
    for n, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[n])
        assert d.max() <= NOISE_BOUND, (flash, n, d.max())
        noisy += int((d > PARAM_ATOL).sum())
        total += d.size
    assert noisy <= MAX_NOISY_FRACTION * total, (flash, noisy, total)
    # the RoPE tables are buffers: not trained, unchanged
    for n, b in tm.named_buffers():
        np.testing.assert_array_equal(b.numpy(), state[n])


def test_config_matches_reference():
    kw = dict(vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
              num_attention_heads=32, num_key_value_heads=8,
              max_position_embeddings=8192, rms_norm_eps=1e-5,
              rope_theta=500000.0)
    for extra in ({}, dict(intermediate_size=14336),
                  dict(num_key_value_heads=None, hidden_size=768)):
        ref = ref_llama.LlamaConfig(**dict(kw, **extra))
        got = tllama.LlamaConfig(**dict(kw, **extra))
        assert vars(got) == vars(ref)
    with pytest.raises(ValueError, match="multiple"):
        tllama.LlamaConfig(num_attention_heads=12, num_key_value_heads=5)


@pytest.mark.parametrize("flag, item", [("fold_layers", "A.3"),
                                        ("sequence_parallel", "A.7")])
def test_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=rf"{flag}.*{item}"):
        tllama.LlamaConfig(**{flag: True})


def test_bridge_rejects_missing_rope_table(bridged):
    _, state, tm = bridged
    partial = {n: a for n, a in state.items() if not n.endswith("rope_sin")}
    with pytest.raises(KeyError, match="rope_sin"):
        tm.load_numpy_state(partial)
