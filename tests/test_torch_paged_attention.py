"""Paged attention (kernel K3) of the PyTorch port against the reference.

The port's plain version (``paddle_tpu_torch/ops/paged_attention.py``) is
held against the reference's Pallas kernel in interpret mode and against
its einsum oracle on the same numpy inputs. The CUDA kernel itself runs
only on the card (``chip_smoke.py`` compares it with this plain version
there); here the wrapper's routing and argument checks are covered.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.nn.functional as PF
from paddle_tpu.framework.op import raw
from paddle_tpu.ops.pallas import paged_attention as pa_kernel
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import paged_attention as tpa

# f32 on both sides over identical stored inputs: only the summation order
# (dense einsum vs the Pallas online softmax) differs, a few ulps of the
# O(1) outputs
ATOL, RTOL = 2e-5, 1e-5


def _case(rng, *, t, hkv, group, page_size, kv, max_pages=3, d=16, s=2):
    """Random paged-cache case (the recipe of tests/test_pallas_attention
    .py): ragged per-slot contexts, unused tail table entries left on the
    trash page 0, start positions placing the T query rows at the tail."""
    h = hkv * group
    n = 1 + s * max_pages
    q = rng.standard_normal((s, t, h, d)).astype(np.float32)
    ctx = rng.integers(t, max_pages * page_size + 1, size=s)
    start = (ctx - t).astype(np.int32)
    table = np.zeros((s, max_pages), np.int32)
    perm = rng.permutation(np.arange(1, n))
    nxt = 0
    for i in range(s):
        used = -(-int(ctx[i]) // page_size)
        table[i, :used] = perm[nxt:nxt + used]
        nxt += used
    ks = vs = None
    if kv == "int8":
        kp = rng.integers(-127, 128, (n, hkv, page_size, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (n, hkv, page_size, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (n, hkv, page_size)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (n, hkv, page_size)).astype(np.float32)
    else:
        kp = rng.standard_normal((n, hkv, page_size, d)).astype(np.float32)
        vp = rng.standard_normal((n, hkv, page_size, d)).astype(np.float32)
    return q, kp, vp, ks, vs, table, start


def _jax_pool(x, kv):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if kv == "bf16" else a


def _torch_pool(x, kv):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if kv == "bf16" else t


def _opt(x, conv):
    return None if x is None else conv(x)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("t", [1, 3])
def test_plain_matches_pallas_and_einsum(t, group, page_size, kv):
    rng = np.random.default_rng(1000 * t + 100 * group + page_size
                                + {"f32": 0, "bf16": 1, "int8": 2}[kv])
    q, kp, vp, ks, vs, table, start = _case(
        rng, t=t, hkv=2, group=group, page_size=page_size, kv=kv)
    jargs = (jnp.asarray(q), _jax_pool(kp, kv), _jax_pool(vp, kv),
             jnp.asarray(table), jnp.asarray(start))
    jscales = dict(k_scales=_opt(ks, jnp.asarray),
                   v_scales=_opt(vs, jnp.asarray))
    pallas = np.asarray(pa_kernel.paged_attention(
        *jargs, interpret=True, **jscales))
    einsum = np.asarray(raw(PF.paged_attention(*jargs, kernel="einsum",
                                               **jscales)), np.float32)
    got = TF.paged_attention(
        torch.from_numpy(q), _torch_pool(kp, kv), _torch_pool(vp, kv),
        torch.from_numpy(table), torch.from_numpy(start),
        k_scales=_opt(ks, torch.from_numpy),
        v_scales=_opt(vs, torch.from_numpy))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), einsum, atol=ATOL, rtol=RTOL)


def test_cpu_route_is_plain_and_not_counted():
    rng = np.random.default_rng(3)
    q, kp, vp, _, _, table, start = _case(rng, t=2, hkv=2, group=2,
                                          page_size=4, kv="f32")
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, start)]
    before = tpa.launches
    got = tpa.paged_attention(*args)
    assert tpa.launches == before
    torch.testing.assert_close(got, tpa.paged_attention_plain(*args),
                               rtol=0, atol=0)


def test_mask_fill_value_matches_reference():
    assert tpa.mask_fill_value() == pa_kernel.mask_fill_value()


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 1, 2, 64), device="meta")
    pool = torch.empty((3, 2, 4, 64), device="meta")
    table = torch.empty((1, 2), dtype=torch.int32, device="meta")
    start = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.paged_attention(x, pool, pool, table, start)
    with pytest.raises(ValueError, match="cuda or cpu"):
        TF.scaled_dot_product_attention(x, x, x, is_causal=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        TF.scaled_dot_product_attention(x, x, x, dropout_p=0.5)


def _kernel_args(d=64, kv=torch.float32, scales=False):
    q = torch.zeros((2, 1, 4, d))
    pool = torch.zeros((5, 2, 4, d), dtype=kv)
    table = torch.zeros((2, 3), dtype=torch.int32)
    start = torch.zeros((2,), dtype=torch.int32)
    sc = torch.ones((5, 2, 4)) if scales else None
    return q, pool, pool, table, start, sc, sc


@pytest.mark.parametrize("bad, err", [
    (dict(d=32), "head_dim"),
    (dict(kv=torch.float16), "pools must share"),
    (dict(kv=torch.int8), "int8 pools need"),
    (dict(scales=True), "int8 pools need"),
])
def test_kernel_argument_checks(bad, err):
    with pytest.raises((TypeError, ValueError), match=err):
        tpa._check_cuda(*_kernel_args(**bad))


def test_kernel_refuses_noncontiguous_and_bad_shapes():
    q, kp, vp, table, start, _, _ = _kernel_args()
    with pytest.raises(ValueError, match="contiguous"):
        tpa._check_cuda(torch.zeros((2, 1, 4, 128))[..., :64], kp, vp,
                        table, start, None, None)
    with pytest.raises(ValueError, match="divisible"):
        tpa._check(q[:, :, :3], kp, vp, table, start, None, None)
    with pytest.raises(ValueError, match="page_table"):
        tpa._check(q, kp, vp, table[:1], start, None, None)
    with pytest.raises(ValueError, match="together"):
        tpa._check(q, kp, vp, table, start, torch.ones(5, 2, 4), None)
