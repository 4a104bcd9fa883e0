"""Arguments of the reference that the PyTorch port honours since ROADMAP
§C.39, each held against ``paddle_tpu`` on the CPU:

* ``nn.Linear(in, out, weight_attr, bias_attr, name)``: the reference's
  positional order, so a ``ParamAttr`` passed positionally reaches the
  weight (its ``trainable``, its initializer) and ``bias_attr=False``
  drops the bias;
* the default initializers of ``nn.Linear`` and ``nn.Embedding``:
  ``XavierNormal``, as the reference's (the two packages draw from
  different generators, so the draws are held to the initializer's std,
  ``sqrt(2 / (fan_in + fan_out))``, within 5 %: 65536 samples put the
  sample std within 0.6 % of it); an explicit ``init_std`` keeps
  ``Normal(0, init_std)``, and GPT's position table its
  ``initializer_range``;
* keywords: ``F.scaled_dot_product_attention(name=)``,
  ``F.paged_attention(kernel=, name=)``, ``distributed.isend`` /
  ``irecv(sync_op=)`` and ``jit.TrainStep(donate=)``.

Each case fails on the tree before the repair; the test of GPT's
position table guards what the repair keeps.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import distributed as rdist
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF

from test_torch_paged_attention import _case

STD_RTOL = 0.05


def _xavier_std(fan_in, fan_out):
    return np.sqrt(2.0 / (fan_in + fan_out))


def test_linear_takes_weight_attr_positionally():
    ref = rnn.Linear(4, 8, rnn.ParamAttr(trainable=False))
    got = tnn.Linear(4, 8, tnn.ParamAttr(trainable=False), device="cpu")
    assert ref.weight.stop_gradient and got.weight.stop_gradient
    assert not got.weight.requires_grad and got.bias.requires_grad
    init = dict(initializer=rnn.initializer.Constant(0.5))
    ref = rnn.Linear(4, 8, rnn.ParamAttr(**init))
    got = tnn.Linear(4, 8, tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.5)), device="cpu")
    np.testing.assert_array_equal(got.weight.detach().numpy(),
                                  np.asarray(raw(ref.weight)))


def test_linear_bias_attr_and_name():
    for args in ((None,), (None, None), (None, None, "fc")):
        ref, got = rnn.Linear(4, 8, *args), tnn.Linear(4, 8, *args,
                                                        device="cpu")
        assert (ref.bias is None) == (got.bias is None) is False
    ref = rnn.Linear(4, 8, None, False)
    got = tnn.Linear(4, 8, None, False, device="cpu")
    assert ref.bias is None and got.bias is None
    assert tnn.Linear(4, 8, bias_attr=False, name="fc",
                      device="cpu").bias is None
    with pytest.raises(TypeError):
        tnn.Linear(4, 8, bias=False, device="cpu")


def test_default_initializers_are_xavier_normal():
    paddle.seed(0)
    cases = [(rnn.Linear(256, 256).weight,
              tnn.Linear(256, 256, device="cpu").weight, 256, 256),
             (rnn.Embedding(1000, 256).weight,
              tnn.Embedding(1000, 256, device="cpu").weight, 1000, 256)]
    for ref, got, a, b in cases:
        want = _xavier_std(a, b)
        for w in (np.asarray(raw(ref)), got.detach().numpy()):
            assert abs(w.std() / want - 1) < STD_RTOL, (w.std(), want)
    # an explicit std keeps its normal
    w = tnn.Linear(256, 256, init_std=0.02, device="cpu").weight
    assert abs(w.detach().std().item() / 0.02 - 1) < STD_RTOL
    w = tnn.Embedding(1000, 256, init_std=0.02, device="cpu").weight
    assert abs(w.detach().std().item() / 0.02 - 1) < STD_RTOL


def test_gpt_position_table_keeps_initializer_range():
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=64, hidden_size=256, num_hidden_layers=1,
                    num_attention_heads=4, max_position_embeddings=1024)
    m = GPTForCausalLM(cfg, device="cpu")
    w = m.gpt.embeddings.position_embeddings.weight.detach()
    assert abs(w.std().item() / cfg.initializer_range - 1) < STD_RTOL


def test_sdpa_takes_name():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 5, 2, 8)).astype(np.float32))
    want = RF.scaled_dot_product_attention(
        paddle.to_tensor(x.numpy()), paddle.to_tensor(x.numpy()),
        paddle.to_tensor(x.numpy()), is_causal=True, training=False,
        name="attn")
    got = TF.scaled_dot_product_attention(x, x, x, is_causal=True,
                                          training=False, name="attn")
    np.testing.assert_allclose(got.numpy(), np.asarray(raw(want)),
                               rtol=1e-5, atol=1e-6)


def test_paged_attention_takes_kernel_and_name():
    rng = np.random.default_rng(1)
    q, kp, vp, _, _, table, start = _case(rng, t=2, hkv=2, group=2,
                                          page_size=4, kv="f32")
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, start)]
    want = np.asarray(raw(RF.paged_attention(
        *[paddle.to_tensor(a) for a in (q, kp, vp, table, start)],
        kernel="einsum", name="pa")))
    for kernel in (None, "auto", "pallas", "einsum", "EINSUM"):
        got = TF.paged_attention(*args, kernel=kernel, name="pa")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    for bad in (RF, TF):
        with pytest.raises(ValueError, match="kernel"):
            bad.paged_attention(*([paddle.to_tensor(a) for a in
                                   (q, kp, vp, table, start)]
                                  if bad is RF else args), kernel="flash")


def test_einsum_kernel_refused_on_a_cuda_tensor(monkeypatch):
    """``kernel="einsum"`` names the plain version: the port takes it on
    a CPU tensor only, never quietly on the card."""
    x = torch.zeros((1, 1, 2, 8))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="einsum"):
        TF.paged_attention(x, x, x, None, None, kernel="einsum")


def test_isend_irecv_take_sync_op():
    for name in ("isend", "irecv"):
        want = list(inspect.signature(getattr(rdist, name)).parameters)
        got = list(inspect.signature(getattr(tdist, name)).parameters)
        assert got == want, name
        assert inspect.signature(getattr(tdist, name)).parameters[
            "sync_op"].default is False


def test_trainstep_takes_donate():
    m = tnn.Linear(2, 2, device="cpu")
    from paddle_tpu_torch import optimizer as topt

    opt = topt.SGD(learning_rate=0.1, parameters=m.parameters())
    step = TrainStep(m, lambda model, x: model(x).sum(), opt, donate=False)
    assert step._donate is False
    assert TrainStep(m, lambda model, x: model(x).sum(), opt)._donate is True
    assert "donate" in inspect.signature(
        paddle.jit.TrainStep.__init__).parameters
    step(torch.ones(3, 2))
