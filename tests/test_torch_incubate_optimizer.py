"""``incubate.LookAhead`` / ``ModelAverage`` of the PyTorch port against
the reference's on the CPU (``tests/test_incubate_optimizer.py``'s cases):
one ``Linear`` from bridged weights, the same numpy batch, SGD steps with
the wrapper on both sides, parameters after every step within 1e-6
relative (atol 1e-7; f32, the same operations in the same order); the
window rotation and ``apply`` / ``restore`` against the reference's and
the plain mean of the history; the state round trip; LookAhead on bf16
parameters under ``multi_precision`` syncing the f32 master.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as rinc
from paddle_tpu.framework.op import raw
import paddle_tpu_torch as tp
from paddle_tpu_torch import incubate as tinc

RTOL, ATOL = 1e-6, 1e-7


def _pair(seed=0):
    """The reference's ``Linear(4, 3)`` and the port's with its weights,
    and one batch for both."""
    paddle.seed(seed)
    ref = paddle.nn.Linear(4, 3)
    port = tp.nn.Linear(4, 3, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight.numpy())))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias.numpy())))
    x = np.random.default_rng(seed).standard_normal((8, 4)).astype("float32")
    return ref, port, x


def _ref_step(layer, x, opt):
    (layer(paddle.to_tensor(x)) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()


def _port_step(layer, x, opt):
    (layer(torch.from_numpy(x)) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()


def _close(port_layer, ref_layer):
    for a, b in zip(port_layer.parameters(), ref_layer.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(raw(b)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k, alpha", [(3, 0.4), (2, 0.5), (1, 1.0)])
def test_lookahead_trajectory_matches_reference(k, alpha):
    ref, port, x = _pair()
    rl = rinc.LookAhead(paddle.optimizer.SGD(0.1, parameters=ref.parameters()),
                        alpha=alpha, k=k)
    pl = tinc.LookAhead(tp.optimizer.SGD(0.1, parameters=port.parameters()),
                        alpha=alpha, k=k)
    for _ in range(7):
        _ref_step(ref, x, rl)
        _port_step(port, x, pl)
        _close(port, ref)


def test_lookahead_state_dict_round_trip_and_checks():
    _, port, x = _pair()
    look = tinc.LookAhead(tp.optimizer.Momentum(0.1,
                                                parameters=port.parameters()),
                          alpha=0.5, k=2)
    for _ in range(3):
        _port_step(port, x, look)
    state = look.state_dict()
    _, port2, _ = _pair()
    look2 = tinc.LookAhead(tp.optimizer.Momentum(
        0.1, parameters=port2.parameters()), alpha=0.5, k=2)
    look2.set_state_dict(state)
    assert look2._global_step == look._global_step == 3
    for i, s in look._slow.items():
        torch.testing.assert_close(look2._slow[i], s, rtol=0, atol=0)
    assert any(k.endswith(".velocity") for k in state)
    inner = tp.optimizer.SGD(0.1, parameters=port.parameters())
    for bad in (dict(inner_optimizer=None), dict(inner_optimizer=inner,
                                                 alpha=1.5),
                dict(inner_optimizer=inner, k=0)):
        with pytest.raises(ValueError):
            tinc.LookAhead(**bad)


def test_lookahead_syncs_the_master_under_multi_precision():
    """bf16 parameters with f32 masters: every k steps the master is the
    slow weight (the reference's eager master arithmetic)."""
    ref, port, x = _pair(1)
    rps = [paddle.nn.layer.Parameter(jnp.asarray(raw(p), jnp.bfloat16))
           for p in ref.parameters()]
    pps = [torch.nn.Parameter(p.detach().to(torch.bfloat16))
           for p in port.parameters()]
    rl = rinc.LookAhead(paddle.optimizer.SGD(0.1, parameters=rps,
                                             multi_precision=True), k=2)
    pl = tinc.LookAhead(tp.optimizer.SGD(0.1, parameters=pps,
                                         multi_precision=True), k=2)
    rng = np.random.default_rng(2)
    for _ in range(4):
        gs = [rng.standard_normal(p.shape).astype(np.float32) for p in pps]
        for p, g in zip(rps, gs):
            p.grad = jnp.asarray(g, jnp.bfloat16)
        for p, g in zip(pps, gs):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        rl.step()
        pl.step()
        for i in range(len(pps)):
            np.testing.assert_allclose(
                pl.inner_optimizer._master[i].numpy(),
                np.asarray(rl.inner_optimizer._master[i]), rtol=RTOL,
                atol=ATOL)
    for i in range(len(pps)):
        torch.testing.assert_close(pl._slow[i], pl.inner_optimizer._master[i],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("window", [2, 3, 100])
def test_model_average_matches_reference(window):
    ref, port, x = _pair()
    ropt = paddle.optimizer.SGD(0.05, parameters=ref.parameters())
    popt = tp.optimizer.SGD(0.05, parameters=port.parameters())
    rma = rinc.ModelAverage(1.0, parameters=ref.parameters(),
                            min_average_window=window,
                            max_average_window=window)
    pma = tinc.ModelAverage(1.0, parameters=port.parameters(),
                            min_average_window=window,
                            max_average_window=window)
    history = []
    for _ in range(5):
        _ref_step(ref, x, ropt)
        rma.step()
        _port_step(port, x, popt)
        pma.step()
        history.append([p.detach().numpy().copy()
                        for p in port.parameters()])
    live = [p.detach().clone() for p in port.parameters()]
    # window 2: the closed window holds steps 3-4, the open one step 5;
    # window 3: steps 1-3 closed, 4-5 open
    keep = {2: history[2:], 3: history, 100: history}[window]
    with rma.apply(), pma.apply():
        _close(port, ref)
        for p, i in zip(port.parameters(), range(2)):
            np.testing.assert_allclose(
                p.detach().numpy(), np.mean([h[i] for h in keep], axis=0),
                rtol=1e-5, atol=1e-6)
    for p, v in zip(port.parameters(), live):
        torch.testing.assert_close(p.detach(), v, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        with pma.apply():
            with pma.apply():
                pass
    with pma.apply(need_restore=False):
        pass
    pma.restore()
    for p, v in zip(port.parameters(), live):
        torch.testing.assert_close(p.detach(), v, rtol=0, atol=0)
