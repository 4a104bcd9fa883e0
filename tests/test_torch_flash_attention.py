"""Flash attention of the PyTorch port (plain versions of kernels K1 / K2)
against the reference's Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed and handed to both sides. The
plain forward / backward are held against ``_fa_forward`` /
``_fa_backward`` with 16-row blocks (so several blocks run), and the
public ``flash_attention`` with autograd against ``jax.grad`` of the
reference's ``flash_attention``. T <= 40 and D in {16, 32}: interpret mode
is slow.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as ref
from paddle_tpu_torch.ops import flash_attention as fa

# f32: both sides accumulate in f32 over different block orders, so
# results agree to a few f32 ulps of values of order 1
F32_TOL = 1e-5
# bf16: o and dq leave in bf16 (one ulp = 2^-8 relative), and the forward
# rounds P to bf16 relative to the running row max, which differs between
# 16-key blocks and the plain version's dense max: 2 bf16 ulps
BF16_TOL = 2 ** -7


def _arr(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bf16":  # values exactly representable on both sides
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.bfloat16() if dtype == "bf16" else t


def _fold(x):  # [B, T, H, D] -> [B*H, T, D]
    return jnp.swapaxes(x, 1, 2).reshape(-1, x.shape[1], x.shape[-1])


def _unfold(x, b):  # [B*H, T, D] -> [B, T, H, D]
    x = np.asarray(x.astype(jnp.float32))
    return x.reshape(b, -1, *x.shape[1:]).transpose(0, 2, 1, 3)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# (causal, Tq, Tk, H, Hkv, bias shape or None, bias grad, dtype)
CASES = {
    "causal-square": (True, 40, 40, 2, 2, None, False, "f32"),
    "causal-tq<tk-gqa-padbias": (True, 24, 40, 4, 2, "B11K", True, "f32"),
    "causal-tq>tk-gqa-deadrows": (True, 40, 24, 4, 2, None, False, "f32"),
    "full-headbias": (False, 32, 32, 2, 2, "1HQK", True, "f32"),
    "full-tq<tk-scalarbias": (False, 24, 40, 4, 2, "1111", True, "f32"),
    "full-rowbias-nograd": (False, 40, 24, 2, 1, "11Q1", False, "f32"),
    "causal-bf16-gqa": (True, 32, 32, 4, 2, None, False, "bf16"),
    "full-bf16-padbias": (False, 24, 40, 2, 2, "B11K", True, "bf16"),
}


def _bias_shape(code, b, h, tq, tk):
    return tuple({"B": b, "H": h, "Q": tq, "K": tk, "1": 1}[c] for c in code)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_and_backward_match_pallas_kernels(name):
    causal, tq, tk, h, hkv, bcode, bgrad, dt = CASES[name]
    b, d = 2, 16
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = _arr(rng, (b, tq, h, d), dt)
    k = _arr(rng, (b, tk, hkv, d), dt)
    v = _arr(rng, (b, tk, hkv, d), dt)
    do = _arr(rng, (b, tq, h, d), dt)
    bias = None if bcode is None else rng.standard_normal(
        _bias_shape(bcode, b, h, tq, tk)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    tol = F32_TOL if dt == "f32" else BF16_TOL

    rbias, bb, bh = None, 1, 1
    if bias is not None:
        bb, bh = bias.shape[:2]
        rbias = jnp.asarray(bias).reshape(bb * bh, *bias.shape[2:])
    jq, jk, jv, jdo = (_fold(_jax(x, dt)) for x in (q, k, v, do))
    o, lse = ref._fa_forward(jq, jk, jv, rbias, causal, scale, h, hkv, bb, bh,
                             16, 16, True)
    tb = None if bias is None else torch.from_numpy(bias)
    to, tlse = fa.flash_attention_forward_plain(
        _torch(q, dt), _torch(k, dt), _torch(v, dt), tb, causal=causal,
        scale=scale)
    assert to.dtype == _torch(q, dt).dtype and tlse.shape == (b, h, tq)
    _close(to, _unfold(o, b), tol, "o")
    _close(tlse.reshape(b * h, tq), np.asarray(lse)[:, :tq], F32_TOL, "lse")

    # the backward gets the reference's own o and lse
    dq, dk, dv, dbias = ref._fa_backward(
        jq, jk, jv, rbias, o, lse, jdo, causal, scale, h, hkv, bb, bh, bgrad,
        16, 16, True)
    got = fa.flash_attention_backward_plain(
        _torch(q, dt), _torch(k, dt), _torch(v, dt), tb,
        _torch(_unfold(o, b), dt),
        torch.from_numpy(np.array(lse)[:, :tq].reshape(b, h, tq)),
        _torch(do, dt), causal=causal, scale=scale, bias_grad=bgrad)
    for g, want, what in zip(got[:3], (_unfold(dq, b), _unfold(dk, b),
                                       _unfold(dv, b)), ("dq", "dk", "dv")):
        assert g.dtype == _torch(q, dt).dtype
        _close(g, want, tol, what)
    if bgrad:
        _close(got[3], np.asarray(dbias).reshape(bias.shape), F32_TOL,
               "dbias")
    else:
        assert got[3] is None


def test_rows_with_no_visible_key_emit_zeros():
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(_arr(rng, (1, 32, 2, 16), "f32"))
               for _ in range(3))
    keep = torch.ones((1, 1, 32, 32), dtype=torch.bool)
    keep[0, 0, 5] = False
    o = fa.flash_attention(q.requires_grad_(), k, v, mask=keep)
    assert torch.equal(o[0, 5], torch.zeros_like(o[0, 5]))
    o.square().sum().backward()
    assert torch.equal(q.grad[0, 5], torch.zeros_like(q.grad[0, 5]))
    assert torch.isfinite(q.grad).all()
    # causal with Tq > Tk: the leading Tq - Tk rows see no key
    o2, lse2 = fa.flash_attention_forward_plain(q[:, :20, :1].detach(),
                                                k[:, :15, :1], v[:, :15, :1],
                                                causal=True)
    assert torch.equal(o2[0, :5], torch.zeros_like(o2[0, :5]))
    assert (lse2[0, 0, :5] == fa.NEG_INF).all() and torch.isfinite(o2).all()


# (causal, Tq, Tk, H, Hkv, bias shape, mask shape, bias_needs_grad)
GRAD_CASES = {
    "causal-gqa": (True, 40, 40, 4, 2, None, None, True),
    "bias-and-mask": (False, 24, 40, 2, 2, "1HQK", "B11K", True),
    "bias-no-grad": (True, 32, 32, 2, 1, "B11K", None, False),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_public_flash_attention_autograd_matches_jax_grad(name):
    causal, tq, tk, h, hkv, bcode, mcode, needs = GRAD_CASES[name]
    b, d = 2, 32
    rng = np.random.default_rng(100 + sorted(GRAD_CASES).index(name))
    q = _arr(rng, (b, tq, h, d), "f32")
    k = _arr(rng, (b, tk, hkv, d), "f32")
    v = _arr(rng, (b, tk, hkv, d), "f32")
    w = _arr(rng, (b, tq, h, d), "f32")  # the output's cotangent
    bias = None if bcode is None else rng.standard_normal(
        _bias_shape(bcode, b, h, tq, tk)).astype(np.float32)
    mask = None if mcode is None else (
        rng.random(_bias_shape(mcode, b, h, tq, tk)) > 0.2)

    def jloss(q_, k_, v_, bias_):
        o = ref.flash_attention(
            q_, k_, v_, causal=causal, bias=bias_,
            mask=None if mask is None else jnp.asarray(mask),
            bias_needs_grad=needs)
        return jnp.sum(o * jnp.asarray(w)), o

    args = [jnp.asarray(x) for x in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    (_, jo), jg = jax.value_and_grad(jloss, argnums=argnums,
                                     has_aux=True)(*args)

    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    to = fa.flash_attention(
        tq_, tk_, tv_, causal=causal, bias=tb,
        mask=None if mask is None else torch.from_numpy(mask),
        bias_needs_grad=needs)
    (to * torch.from_numpy(w)).sum().backward()
    _close(to.detach(), jo, F32_TOL, "o")
    leaves = [tq_, tk_, tv_] + ([tb] if tb is not None else [])
    for t, g, what in zip(leaves, jg, ("dq", "dk", "dv", "dbias")):
        _close(t.grad, g, F32_TOL, what)
    if tb is not None and not needs:
        assert not tb.grad.any()


def test_check_rejects_bad_shapes():
    x = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(x, torch.zeros((1, 8, 2, 16)),
                           torch.zeros((1, 8, 2, 16)))
    with pytest.raises(ValueError, match="broadcast"):
        fa.flash_attention(x, x, x, bias=torch.zeros((1, 2, 8, 8)))
    with pytest.raises(ValueError, match="rank-4"):
        fa.flash_attention(x, x, x, bias=torch.zeros((8, 8)))


def test_cuda_checks_raise_and_never_fall_back():
    q = torch.zeros((1, 8, 2, 96))
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_cuda(q, q, q, None)
    h = torch.zeros((1, 8, 2, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        fa._check_cuda(h, h, h, None)
    f = torch.zeros((1, 8, 2, 64))
    with pytest.raises(TypeError, match="dtype"):
        fa._check_cuda(f, f.bfloat16(), f, None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(torch.zeros((1, 8, 2, 64), device="meta")
                             for _ in range(3)))


def test_plain_route_counts_no_kernel_launch():
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    x = torch.randn((1, 16, 2, 16), requires_grad=True)
    fa.flash_attention(x, x, x, causal=True).sum().backward()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before
