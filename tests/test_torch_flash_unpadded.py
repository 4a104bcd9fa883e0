"""``nn.functional.flash_attention.flash_attn_unpadded`` of the PyTorch
port against the reference's on the CPU, and the §A.3 step helpers.

The reference's sweep (``tests/test_attention_kernels.py``: packed
sequences causal and not, a decode-style query against a longer key run,
padding tokens past ``cu_seqlens[-1]``, causal rows of a sequence whose
q-length exceeds its k-length; the last three packed into one call, each
distinct shape costing the reference a few seconds of compile), through
the port's plain K1 / K2 (CPU tensors): the output and the gradients of
q, k and v against the reference's (its dense route at these lengths, and
its tape's backward) within 2e-5 relative, 2e-6 absolute (f32; the plain versions sum in another order than the dense
softmax). Dead rows are exactly zero and every gradient finite. With
``_is_cuda`` patched and the ``*_cuda`` entry points pointed at counting
plain versions, one call launches K1, K2a and K2b once each and nothing
else.

Then ``recompute_sequential`` / ``recompute_hybrid`` (gradients equal to
the run without) and ``TrainStep.repeat`` / ``run_steps`` against a loop
of steps, bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional.flash_attention import (
    flash_attn_unpadded as ref_unpadded)
from paddle_tpu_torch.nn.functional.flash_attention import (
    flash_attn_unpadded)
from paddle_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 2e-5, 2e-6

# name -> (cu_seqlens_q, cu_seqlens_k, Tq, Tk, causal, H, D); a total past
# cu[-1] is padding. "mixed" packs the reference's other cases into one
# call: a decode-style query against five keys, a sequence whose q-length
# (5) exceeds its k-length (3), one of equal lengths, and padding tails.
CASES = {
    "packed": ([0, 5, 14, 17], [0, 5, 14, 17], 17, 17, False, 2, 16),
    "packed-causal": ([0, 5, 14, 17], [0, 5, 14, 17], 17, 17, True, 2, 16),
    "mixed-causal": ([0, 1, 6, 8], [0, 5, 8, 10], 10, 12, True, 2, 8),
    "mixed": ([0, 1, 6, 8], [0, 5, 8, 10], 10, 12, False, 2, 8),
}


def _inputs(case, seed=0):
    cu_q, cu_k, tq, tk, _, h, d = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((tq, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((tk, h, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((tk, h, d)).astype(np.float32)
    w = rng.standard_normal((tq, h, d)).astype(np.float32)
    return q, k, v, w, np.asarray(cu_q, np.int32), np.asarray(cu_k, np.int32)


def _ref(case):
    q, k, v, w, cu_q, cu_k = _inputs(case)
    causal, d = CASES[case][4], q.shape[-1]
    rq, rk, rv = (paddle.to_tensor(x, stop_gradient=False) for x in (q, k, v))
    out, _ = ref_unpadded(rq, rk, rv, paddle.to_tensor(cu_q),
                          paddle.to_tensor(cu_k), 0, 0, d ** -0.5,
                          causal=causal)
    (out * paddle.to_tensor(w)).sum().backward()
    return [np.asarray(t.numpy()) for t in (out, rq.grad, rk.grad, rv.grad)]


def _port(case):
    q, k, v, w, cu_q, cu_k = _inputs(case)
    causal, d = CASES[case][4], q.shape[-1]
    pq, pk, pv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, soft = flash_attn_unpadded(pq, pk, pv, torch.from_numpy(cu_q),
                                    torch.from_numpy(cu_k), 0, 0, d ** -0.5,
                                    causal=causal)
    assert soft is None
    (out * torch.from_numpy(w)).sum().backward()
    return [t.detach().numpy() for t in (out, pq.grad, pk.grad, pv.grad)]


def _dead_rows(case):
    """The query rows that see no key."""
    cu_q, cu_k, tq, _, causal, _, _ = CASES[case]
    dead = np.ones(tq, bool)
    for s in range(len(cu_q) - 1):
        lq, lk = cu_q[s + 1] - cu_q[s], cu_k[s + 1] - cu_k[s]
        for i in range(lq):
            dead[cu_q[s] + i] = lk == 0 or (causal and i + lk - lq < 0)
    return dead


@pytest.mark.parametrize("case", sorted(CASES))
def test_unpadded_matches_reference(case):
    ref, port = _ref(case), _port(case)
    for name, a, b in zip(("out", "dq", "dk", "dv"), port, ref):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    dead = _dead_rows(case)
    assert (port[0][dead] == 0).all() and (port[1][dead] == 0).all()
    assert np.abs(port[0][~dead]).min(axis=(1, 2)).max() > 0


def test_unpadded_refusals():
    q = torch.zeros(4, 1, 8)
    cu = torch.tensor([0, 4])
    with pytest.raises(NotImplementedError):
        flash_attn_unpadded(q, q, q, cu, cu, 4, 4, 1.0, dropout=0.1)
    with pytest.raises(NotImplementedError):
        flash_attn_unpadded(q, q, q, cu, cu, 4, 4, 1.0, return_softmax=True)


def test_unpadded_on_cuda_launches_k1_k2_once_each(monkeypatch):
    """The route a CUDA tensor takes: one launch of each of K1, K2a, K2b a
    forward and backward, the mask folded into a ``[1, 1, Tq, Tk]`` bias
    that takes no gradient (no dS pass)."""
    calls = []

    def counting(name, plain):
        def f(*a, **k):
            calls.append((name, tuple(a[3].shape) if a[3] is not None
                          else None))
            return plain(*a, **k)
        return f

    monkeypatch.setattr(tfa, "_is_cuda", lambda q: True)
    monkeypatch.setattr(tfa, "flash_attention_forward_cuda",
                        counting("fwd", tfa.flash_attention_forward_plain))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq_cuda",
                        counting("dq", tfa.flash_attention_bwd_dq_plain))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv_cuda",
                        counting("dkv", tfa.flash_attention_bwd_dkv_plain))
    got = _port("mixed-causal")
    assert [c[0] for c in calls] == ["fwd", "dq", "dkv"]
    assert all(c[1] == (1, 1, 10, 12) for c in calls)
    ref = _ref("mixed-causal")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 8), torch.nn.GELU(),
                               torch.nn.Linear(8, 3))


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_gradients_equal_plain(segments):
    from paddle_tpu_torch.distributed import fleet

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 6)).astype(np.float32)).requires_grad_()
    plain = _mlp()
    (plain(x) ** 2).sum().backward()
    want = [p.grad.clone() for p in plain.parameters()] + [x.grad.clone()]
    x.grad = None
    net = _mlp()
    out = fleet.recompute_sequential({"segments": segments}, net, x,
                                     granularity="full")
    (out ** 2).sum().backward()
    got = [p.grad for p in net.parameters()] + [x.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_recompute_hybrid():
    from paddle_tpu_torch.distributed.fleet.utils import recompute_hybrid

    net, plain = _mlp(1), _mlp(1)
    x = torch.ones(2, 6)
    (recompute_hybrid({"mp_group": None, "offload": False}, net, x)
     .sum()).backward()
    plain(x).sum().backward()
    for a, b in zip(net.parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        recompute_hybrid({"partition": True}, net, x)


def _train_step(seed=2):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep

    net = _mlp(seed)
    opt = topt.Adam(learning_rate=topt.lr.StepDecay(0.01, step_size=1,
                                                    gamma=0.5),
                    parameters=net.parameters())
    return net, TrainStep(net, lambda m, x, y: ((m(x) - y) ** 2).mean(),
                          opt)


def test_repeat_and_run_steps_equal_a_loop():
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal((3, 4, 6)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((3, 4, 3)).astype(np.float32))
    net_a, step_a = _train_step()
    loop = torch.stack([step_a(xs[0], ys[0]) for _ in range(3)])
    net_b, step_b = _train_step()
    rep = step_b.repeat(3, xs[0], ys[0])
    torch.testing.assert_close(rep, loop, rtol=0, atol=0)
    for a, b in zip(net_a.parameters(), net_b.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    net_c, step_c = _train_step()
    loop = torch.stack([step_c(xs[i], ys[i]) for i in range(3)])
    net_d, step_d = _train_step()
    torch.testing.assert_close(step_d.run_steps(xs, ys), loop, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="leading axis"):
        step_d.run_steps(xs, ys[:2])
    with pytest.raises(NotImplementedError, match="§A.3"):
        step_d.cost_analysis(xs[0], ys[0])
    with pytest.raises(NotImplementedError, match="§A.3"):
        step_d.memory_analysis(xs[0], ys[0])
