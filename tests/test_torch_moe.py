"""MoE layers of the PyTorch port against the reference, on weights bridged
with ``state_from_numpy``: the dropless ``MoELayer`` (routing asserted
equal first, then output and aux loss), the capacity routing, gradients
of every parameter, a 3-step ``TrainStep`` + ``AdamW`` trajectory of a
tiny MoE regressor, ``FusedEcMoe``, and the initializers, activations and
``mse_loss`` the layers use."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.incubate import MoELayer as RefMoE
from paddle_tpu.incubate.nn import FusedEcMoe as RefEcMoe
from paddle_tpu.incubate.nn import fused_ec_moe as ref_fused_ec_moe
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.nn.initializer import _fans as ref_fans
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import state_from_numpy
from paddle_tpu_torch.incubate import FusedEcMoe, MoELayer, fused_ec_moe
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers.common import Linear
from paddle_tpu_torch.ops import grouped_matmul as gm

from torch_port_utils import no_mesh, numpy_state

# f32 through two small expert matmuls, softmax and GELU on both sides
OUT_TOL = 1e-5
# gradients: a few ulps of each parameter's largest gradient
GRAD_TOL = 1e-5
# the smallest gap between the k-th and (k+1)-th gate probability of any
# token: far above f32 noise, so both sides route alike
MIN_MARGIN = 1e-4
LR = 1e-3
STEPS = 3


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_moe(seed, **kw):
    paddle.seed(seed)
    m = RefMoE(**kw)
    m.eval()
    return m


def _port(module, state):
    module.load_state_dict(state_from_numpy(state, "cpu",
                                            expected=module.state_dict()))
    return module


def _port_moe(ref, **kw):
    return _port(MoELayer(**kw, device="cpu").eval(), numpy_state(ref))


def _assert_same_routing(ref, port, x, k):
    flat = x.reshape(-1, x.shape[-1])
    probs_r = np.asarray(jax.nn.softmax(raw(ref.gate(Tensor(flat))), -1))
    with torch.no_grad():
        probs_t = torch.softmax(port.gate(torch.from_numpy(flat)), -1)
    top_r = np.asarray(jax.lax.top_k(jnp.asarray(probs_r), k)[1])
    top_t = torch.topk(probs_t, k).indices.numpy()
    np.testing.assert_array_equal(top_t, top_r)
    srt = -np.sort(-probs_r, -1)
    assert (srt[:, k - 1] - srt[:, k]).min() > MIN_MARGIN


DROPLESS = dict(d_model=16, d_hidden=32, num_experts=4, top_k=2,
                drop_tokens=False)


def test_dropless_forward_and_aux_loss_match_reference():
    x = _x((2, 8, 16), 3)
    with no_mesh():
        ref = _ref_moe(0, **DROPLESS)
        want = np.asarray(raw(ref(Tensor(x))))
        want_aux = float(np.asarray(raw(ref.last_aux_loss)))
        port = _port_moe(ref, **DROPLESS)
        _assert_same_routing(ref, port, x, 2)
    before = (gm.launches_fwd, gm.launches_drhs)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert (gm.launches_fwd, gm.launches_drhs) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_TOL, atol=1e-6)
    np.testing.assert_allclose(float(port.last_aux_loss), want_aux,
                               rtol=1e-6)


def test_capacity_routing_matches_reference_in_eval_mode():
    kw = dict(d_model=16, d_hidden=32, num_experts=4, top_k=2)
    x = _x((2, 8, 16), 5)
    with no_mesh():
        ref = _ref_moe(0, **kw)
        want = np.asarray(raw(ref(Tensor(x))))
        want_aux = float(np.asarray(raw(ref.last_aux_loss)))
        port = _port_moe(ref, **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_TOL, atol=1e-6)
    np.testing.assert_allclose(float(port.last_aux_loss), want_aux,
                               rtol=1e-6)


def test_capacity_drops_tokens_as_the_reference():
    kw = dict(d_model=8, d_hidden=16, num_experts=2, top_k=1,
              capacity_factor=0.1)
    x = _x((1, 16, 8), 6)
    with no_mesh():
        ref = _ref_moe(0, **kw)
        want = np.asarray(raw(ref(Tensor(x))))
        port = _port_moe(ref, **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    # capacity = ceil(0.1 * 16 / 2) = 1 per expert: at most 2 tokens routed
    assert (np.abs(got[0]).sum(-1) > 1e-6).sum() <= 2
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=1e-6)


def test_capacity_noise_comes_from_the_layer_generator():
    kw = dict(d_model=8, d_hidden=16, num_experts=4, device="cpu")
    x = torch.from_numpy(_x((2, 8, 8), 7))
    a, b = MoELayer(**kw, seed=3), MoELayer(**kw, seed=3)
    assert torch.equal(a(x), b(x))          # training mode: same noise
    c = MoELayer(**kw, seed=3).eval()
    assert torch.equal(c(x), c(x))          # eval mode: no noise


@pytest.mark.parametrize("drop_tokens", [False, True])
def test_gradients_of_every_parameter_match_reference(drop_tokens):
    kw = dict(d_model=16, d_hidden=32, num_experts=4, top_k=2,
              drop_tokens=drop_tokens)
    x = _x((2, 8, 16), 3)
    with no_mesh():
        ref = _ref_moe(0, **kw)
        port = _port_moe(ref, **kw)
        _assert_same_routing(ref, port, x, 2)
        rx = Tensor(jnp.asarray(x), stop_gradient=False)
        y = ref(rx)
        ((y * y).mean() + ref.last_aux_loss).backward()
    want = {n: np.asarray(raw(p.grad)) for n, p in ref.named_parameters()}
    want["x"] = np.asarray(raw(rx.grad))
    tx = torch.from_numpy(x).requires_grad_()
    y = port(tx)
    ((y * y).mean() + port.last_aux_loss).backward()
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    got["x"] = tx.grad.numpy()
    assert sorted(got) == sorted(want)
    for n, g in want.items():
        scale = np.abs(g).max()
        assert scale > 0, n
        err = np.abs(got[n] - g).max()
        assert err <= GRAD_TOL * scale, (n, err, scale)


def _ref_regressor():
    class Net(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.moe = RefMoE(d_model=8, d_hidden=16, num_experts=4, top_k=2,
                              drop_tokens=False)
            self.head = paddle.nn.Linear(8, 1)

        def forward(self, x):
            return self.head(self.moe(x))

    paddle.seed(1)
    return Net()


class _Regressor(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.moe = MoELayer(8, 16, 4, top_k=2, drop_tokens=False,
                            device="cpu")
        self.head = Linear(8, 1, device="cpu")

    def forward(self, x):
        return self.head(self.moe(x))


def _regression_loss(mse):
    return lambda m, x, y: mse(m(x), y) + m.moe.last_aux_loss


def _adamw(params, opt_mod, clip):
    return opt_mod.AdamW(learning_rate=LR, beta1=0.9, beta2=0.95,
                         epsilon=1e-8, parameters=params, weight_decay=0.1,
                         grad_clip=clip(1.0))


def test_train_step_trajectory_matches_reference():
    x, y = _x((4, 8, 8), 4), _x((4, 8, 1), 5)
    with no_mesh():
        net = _ref_regressor()
        state = numpy_state(net)
        step = RefTrainStep(net, _regression_loss(RF.mse_loss),
                            _adamw(net.parameters(), paddle.optimizer,
                                   paddle.nn.ClipGradByGlobalNorm))
        want_losses = [float(np.asarray(raw(step(Tensor(jnp.asarray(x)),
                                                 Tensor(jnp.asarray(y))))))
                       for _ in range(STEPS)]
        want = {n: np.asarray(raw(p)) for n, p in net.named_parameters()}
    port = _port(_Regressor(), state)
    opt = _adamw(port.parameters(), topt, topt.ClipGradByGlobalNorm)
    tstep = TrainStep(port, _regression_loss(F.mse_loss), opt)
    losses = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=OUT_TOL)
    assert losses[-1] < losses[0]
    # Adam moves an element by about lr per step whatever its gradient's
    # size, so a gradient that is float noise on both sides may drift by
    # 2 lr a step; all but a few elements stay within 1e-5
    noisy = total = 0
    for n, p in port.named_parameters():
        d = np.abs(p.detach().numpy() - want[n])
        assert d.max() <= 2 * LR * STEPS, (n, d.max())
        noisy += int((d > 1e-5).sum())
        total += d.size
    assert noisy <= 0.01 * total, (noisy, total)


def test_fused_ec_moe_matches_reference():
    x = _x((2, 8, 16), 8)
    paddle.seed(2)
    ref = RefEcMoe(16, 32, 4)
    want = np.asarray(raw(ref(Tensor(x))))
    port = _port(FusedEcMoe(16, 32, 4, device="cpu"), numpy_state(ref))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_TOL, atol=1e-6)
    # functional form over precomputed gate logits [b, s, E], relu experts
    st = numpy_state(ref)
    logits = _x((2, 8, 4), 9)
    args = [st[k] for k in ("w1", "b1", "w2", "b2")]
    want = np.asarray(raw(ref_fused_ec_moe(Tensor(x), Tensor(logits),
                                           *map(Tensor, args),
                                           act_type="relu")))
    got = fused_ec_moe(torch.from_numpy(x), torch.from_numpy(logits),
                       *map(torch.tensor, args), act_type="relu")
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_TOL, atol=1e-6)
    with pytest.raises(ValueError, match="act_type"):
        FusedEcMoe(16, 32, 4, act_type="elu", device="cpu")


@pytest.mark.parametrize("shape", [(5,), (64, 32), (8, 64, 128),
                                   (16, 8, 3, 3)])
def test_initializer_fans_and_spread_follow_reference(shape):
    assert I._fans(shape) == ref_fans(shape)
    fi, fo = ref_fans(shape)
    gen = torch.Generator().manual_seed(0)
    w = I.XavierNormal()(shape, generator=gen)
    assert w.shape == shape and w.dtype == torch.float32
    want_std = np.sqrt(2.0 / (fi + fo))
    # sample std of n normals: within 5 / sqrt(2n) of the true one
    n = w.numel()
    assert abs(float(w.std()) / want_std - 1) <= 5 / np.sqrt(2 * n)
    limit = np.sqrt(6.0 / (fi + fo))
    u = I.XavierUniform()(shape, generator=gen)
    assert float(u.abs().max()) <= limit
    assert torch.equal(I.Constant(0.5)(shape), torch.full(shape, 0.5))
    z = I.Normal(1.0, 2.0)((4096,), generator=gen)
    assert abs(float(z.mean()) - 1.0) < 0.15 and abs(float(z.std()) - 2) < 0.1


def test_activations_and_mse_match_reference():
    x = _x((3, 7), 10) * 3
    t, j = torch.from_numpy(x), Tensor(jnp.asarray(x))
    pairs = [(F.gelu(t), RF.gelu(j)),
             (F.gelu(t, approximate=True), RF.gelu(j, approximate=True)),
             (F.relu(t), RF.relu(j)), (F.silu(t), RF.silu(j)),
             (F.softmax(t, axis=0), RF.softmax(j, axis=0))]
    y = _x((3, 7), 11)
    for red in ("mean", "sum", "none"):
        pairs.append((F.mse_loss(t, torch.from_numpy(y), reduction=red),
                      RF.mse_loss(j, Tensor(jnp.asarray(y)), reduction=red)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(raw(want)),
                                   rtol=1e-6, atol=1e-6)
