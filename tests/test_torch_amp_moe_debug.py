"""The rest of AMP in the PyTorch port against the reference (CPU):

* ``MoELayer`` (capacity and dropless) ``decorate``d O2 and called under
  ``auto_cast("O2")``: output dtype, loss and the gradients of every
  parameter, on bridged bf16 weights. Both run the routing ops
  (``moe_gate_dispatch``, ``moe_apply``, ``moe_apply_dropless``) in bf16,
  the gate's softmax and the aux loss in f32. Tolerance: every op rounds
  to bf16 (u = 2^-8), XLA and torch in different orders; measured loss
  rel 0.37 u and gradients 2 u of each parameter's largest (stored in
  bf16, one ulp = 2 u), held at 2 u and 4 u;
* ``amp.debugging``: the operator stats of a tiny GPT's and Llama's
  forward at O1 and O2, equal to the reference's (op name, dtype, calls),
  and the tensor checker aborting on an injected ``inf``;
* ``fleet.utils.mix_precision_utils``: ``MixPrecisionLayer`` casts like
  the reference's, ``MixPrecisionOptimizer`` steps AdamW through f32
  masters as the reference's eager ``step`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as ref_amp
from paddle_tpu.amp import debugging as rdbg
from paddle_tpu.distributed.fleet.utils import mix_precision_utils as rmpu
from paddle_tpu.framework import rng as ref_rng
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.incubate import MoELayer as RefMoE
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.distributed.fleet.utils import mix_precision_utils
from paddle_tpu_torch.framework import op as top
from paddle_tpu_torch.framework import state_from_numpy
from paddle_tpu_torch.incubate import MoELayer
from paddle_tpu_torch import tensor as TT

from torch_port_utils import (VOCAB, jax_tiny_gpt, jax_tiny_llama,
                              no_mesh, numpy_state, torch_tiny_gpt,
                              torch_tiny_llama)

BF16_U = 2.0 ** -8


def _ref_moe_loss_grads(ref, x):
    """The reference's loss ``mean(out^2) + aux`` and its gradients (f32
    numpy, by name) through its ``TrainStep`` loss closure under
    ``auto_cast("O2")`` (its eager backward fails under AMP, ROADMAP.md
    C.9)."""
    def loss_fn(model, xx):
        with ref_amp.auto_cast(level="O2"):
            out = model(xx)
        o = raw(out).astype(jnp.float32)
        return Tensor(jnp.mean(o * o) + raw(model.last_aux_loss))

    step = RefTrainStep(ref, loss_fn,
                        paddle.optimizer.SGD(parameters=ref.parameters()))
    p_vals = [p._value for p in step._params]
    b_vals = [b._value for b in step._buffers + step._extra_params]
    (loss, _), grads = jax.value_and_grad(step._make_loss_of(),
                                          has_aux=True)(
        p_vals, (b_vals, [jnp.asarray(x)], ref_rng.next_key()))
    names = {id(p): n for n, p in ref.named_parameters()}
    assert {str(g.dtype) for g in grads} == {"bfloat16"}
    return float(loss), {names[id(p)]: np.asarray(g, np.float32)
                         for p, g in zip(step._params, grads)}


@pytest.mark.parametrize("drop_tokens", [True, False],
                         ids=["capacity", "dropless"])
def test_moe_under_o2_matches_reference(drop_tokens):
    kw = dict(d_model=16, d_hidden=32, num_experts=4, top_k=2,
              drop_tokens=drop_tokens)
    x = np.random.default_rng(3).standard_normal((2, 8, 16)).astype(
        np.float32)
    with no_mesh():
        paddle.seed(0)
        ref = RefMoE(**kw)
        ref.eval()
        ref_amp.decorate(ref, level="O2")
        want_loss, want = _ref_moe_loss_grads(ref, x)
        state = numpy_state(ref)
    port = MoELayer(**kw, device="cpu").eval()
    amp.decorate(port, level="O2")
    port.load_state_dict(state_from_numpy(state, "cpu",
                                          expected=port.state_dict()))
    with amp.auto_cast(level="O2"):
        out = port(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    assert port.last_aux_loss.dtype == torch.float32
    o = out.float()
    loss = (o * o).mean() + port.last_aux_loss
    loss.backward()
    assert abs(loss.item() - want_loss) <= 2 * BF16_U * abs(want_loss)
    for n, p in port.named_parameters():
        assert p.grad.dtype == torch.bfloat16, n
        g = p.grad.float().numpy()
        assert np.abs(g - want[n]).max() <= 4 * BF16_U * np.abs(
            want[n]).max(), n


MODELS = {"gpt": (jax_tiny_gpt, torch_tiny_gpt),
          "llama": (jax_tiny_llama, torch_tiny_llama)}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("model", MODELS)
def test_operator_stats_equal_reference(model, level):
    """Every op both packages route through their gateways, with its
    output dtype and call count: the tiny models' forwards route the same
    ops (the ops the port leaves outside its gateway are listed in
    ``amp/debugging.py``)."""
    jax_model, torch_model = MODELS[model]
    ids = np.random.default_rng(0).integers(1, VOCAB, (2, 9))
    with jax_model() as jm:
        tm = torch_model(numpy_state(jm))
        rdbg.enable_operator_stats_collection()
        try:
            with ref_amp.auto_cast(level=level):
                jm(paddle.to_tensor(ids))
        finally:
            want = rdbg.disable_operator_stats_collection()
    tdbg.enable_operator_stats_collection()
    try:
        with amp.auto_cast(level=level), torch.no_grad():
            tm(torch.as_tensor(ids))
    finally:
        got = tdbg.disable_operator_stats_collection()
    assert got == want
    assert ("linear", "bfloat16") in got
    with tdbg.collect_operator_stats():
        assert top._op_observer is not None
    assert top._op_observer is None  # off again: one test a call


def test_tensor_checker_aborts_on_an_injected_inf():
    x = np.ones((2, 4), np.float32)
    x[1, 2] = np.inf
    for dbg, exp, conv in ((rdbg, paddle.exp, paddle.to_tensor),
                           (tdbg, TT.exp, torch.from_numpy)):
        c = dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT,
            checked_op_list=["exp"])
        dbg.enable_tensor_checker(c)
        assert dbg.current_checker() is c
        # the reference's checker runs inside the stats collection (its
        # observer is installed there); the port's runs either way
        dbg.enable_operator_stats_collection()
        try:
            with pytest.raises(FloatingPointError, match="exp"):
                exp(conv(x))
        finally:
            dbg.disable_operator_stats_collection()
            dbg.disable_tensor_checker()
        assert dbg.current_checker() is None
    # the port's checker alone
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    try:
        with pytest.raises(FloatingPointError):
            TT.exp(torch.from_numpy(x))
    finally:
        tdbg.disable_tensor_checker()
    TT.exp(torch.from_numpy(x))  # off: no check
    for dbg, conv, val in ((rdbg, paddle.to_tensor, raw),
                           (tdbg, torch.from_numpy, lambda t: t)):
        n_nan, n_inf, n_zero = dbg.check_numerics(
            conv(np.array([np.nan, np.inf, 0.0, 1.0], np.float32)),
            debug_mode=dbg.DebugMode.CHECK_NAN_INF)
        assert [int(np.asarray(val(v))) for v in (n_nan, n_inf, n_zero)] \
            == [1, 1, 1]


def test_mix_precision_layer_and_optimizer_match_reference():
    """A bridged ``Linear(8, 4)``: the wrapped layer's parameters bf16 and
    its state under the wrapped names, as the reference's; three AdamW
    steps on the same bf16 gradients through f32 masters equal the
    reference's eager ``step``."""
    hp = dict(learning_rate=1e-2, weight_decay=0.1)
    paddle.seed(1)
    ref_lin = paddle.nn.Linear(8, 4)
    lin = tnn.Linear(8, 4, device="cpu")
    lin.load_state_dict(state_from_numpy(numpy_state(ref_lin), "cpu",
                                         expected=lin.state_dict()))
    ref_m = rmpu.MixPrecisionLayer(ref_lin, dtype="bfloat16")
    m = mix_precision_utils.MixPrecisionLayer(lin, dtype="bfloat16")
    assert sorted(m.state_dict()) == sorted(ref_m.state_dict()) == [
        "bias", "weight"]
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    ref_opt = rmpu.MixPrecisionOptimizer(
        paddle.optimizer.AdamW(parameters=ref_m.parameters(), **hp))
    opt = mix_precision_utils.MixPrecisionOptimizer(
        topt.AdamW(parameters=list(m.parameters()), **hp))
    assert opt._multi_precision and opt._inner._multi_precision
    rng = np.random.default_rng(2)
    ref_params = dict(ref_m._layers.named_parameters())
    params = dict(m._layers.named_parameters())
    for _ in range(3):
        for n, p in params.items():
            g = torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32)).bfloat16()
            p.grad = g
            ref_params[n].grad = Tensor(jnp.asarray(g.float().numpy(),
                                                    jnp.bfloat16))
        opt.step()
        opt.clear_grad()
        ref_opt.step()
        ref_opt.clear_grad()
    x = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
    for n, p in params.items():
        want = np.asarray(raw(ref_params[n]), np.float32)
        got = p.detach().float().numpy()
        # each a master rounded to bf16; a master on a rounding boundary
        # may round either way
        assert np.all(np.abs(got - want) <= BF16_U * np.abs(want)), n
    with torch.no_grad():
        out = m(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
