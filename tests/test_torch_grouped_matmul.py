"""Grouped matmul of the PyTorch port against the reference Pallas kernel
(interpret mode on the CPU): the plain K4a forward over the reference
tests' group layouts, dlhs / drhs through ``GroupedMatmulFunction``
against ``jax.grad`` of the Pallas path, the zero rows and zero gradients
of padding and empty groups, and the kernel dispatch."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.grouped_matmul import grouped_matmul as ref_gmm
from paddle_tpu_torch.ops import grouped_matmul as gm

# f32 products of length K <= 33 on both sides, summed in other orders
FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# (sizes, M, K, N): the six layouts of the reference tests, N = 192 (not a
# tile multiple) and an odd K
CASES = [
    ([64, 64], 128, 32, 64),          # aligned groups
    ([50, 30, 48], 128, 32, 64),      # ragged, boundary-spanning tiles
    ([0, 100, 0, 28], 128, 32, 64),   # empty groups
    ([128, 0, 0], 128, 32, 64),       # trailing empties
    ([30, 40], 128, 32, 64),          # padding tail rows
    ([100, 156], 256, 32, 64),        # group spanning several tiles
    ([40, 60, 28], 128, 32, 192),     # N not a block multiple
    ([50, 30, 48], 128, 33, 40),      # odd K
]


def _mk(m, k, n, g, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((g, k, n)).astype(np.float32)
    return lhs, rhs


def _reference(lhs, rhs, sizes):
    out = np.zeros((lhs.shape[0], rhs.shape[2]), np.float32)
    start = 0
    for g, s in enumerate(sizes):
        out[start:start + s] = lhs[start:start + s] @ rhs[g]
        start += s
    return out


def _ids(case):
    sizes, m, k, n = case
    return f"{'-'.join(map(str, sizes))}_M{m}_K{k}_N{n}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_forward_matches_pallas_kernel(case):
    sizes, m, k, n = case
    lhs, rhs = _mk(m, k, n, len(sizes))
    want = np.asarray(ref_gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                              jnp.asarray(sizes), block_m=64))
    before = (gm.launches_fwd, gm.launches_drhs)
    got = gm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                            torch.tensor(sizes))
    assert (gm.launches_fwd, gm.launches_drhs) == before
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[6]], ids=_ids)
def test_grads_match_jax_grad_of_pallas_path(case):
    sizes, m, k, n = case
    lhs, rhs = _mk(m, k, n, len(sizes), seed=2)
    sz = jnp.asarray(sizes, jnp.int32)

    def f(l, r):
        return (ref_gmm(l, r, sz, block_m=64) ** 2).sum()

    want_l, want_r = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs),
                                                 jnp.asarray(rhs))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    (gm.GroupedMatmulFunction.apply(tl, tr, torch.tensor(sizes,
                                                         dtype=torch.int32))
     ** 2).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want_l),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(want_r),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_padding_rows_and_empty_group_grads_are_exactly_zero():
    sizes = [0, 40, 0, 30]
    lhs, rhs = _mk(128, 16, 24, 4, seed=3)
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = gm.grouped_matmul(tl, tr, sizes)
    assert torch.equal(out[70:], torch.zeros_like(out[70:]))
    (out ** 2).sum().backward()
    for g in (0, 2):
        assert torch.equal(tr.grad[g], torch.zeros_like(tr.grad[g]))
    assert torch.equal(tl.grad[70:], torch.zeros_like(tl.grad[70:]))
    drhs = gm.grouped_matmul_drhs_plain(tl.detach(), torch.ones((128, 24)),
                                        torch.tensor(sizes))
    assert drhs.dtype == torch.float32 and not drhs[[0, 2]].any()


def test_new_sizes_through_the_same_function():
    lhs, rhs = _mk(128, 16, 32, 3, seed=1)
    tl, tr = torch.from_numpy(lhs), torch.from_numpy(rhs)
    for sizes in ([40, 60, 28], [0, 128, 0], [10, 10, 10]):
        got = gm.GroupedMatmulFunction.apply(
            tl, tr, torch.tensor(sizes, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), _reference(lhs, rhs, sizes),
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_bf16_plain_accumulates_in_f32_and_keeps_the_dtype():
    sizes = [50, 30, 48]
    lhs, rhs = _mk(128, 32, 64, 3, seed=4)
    tl = torch.from_numpy(lhs).bfloat16()
    tr = torch.from_numpy(rhs).bfloat16()
    got = gm.grouped_matmul(tl, tr, sizes)
    assert got.dtype == torch.bfloat16
    want = _reference(tl.float().numpy(), tr.float().numpy(), sizes)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(want).max())


@pytest.fixture
def counting(monkeypatch):
    """CPU tensors routed as CUDA ones, onto counting wrappers of the plain
    versions; returns the calls made."""
    calls = []

    def fwd(lhs, rhs, sizes):
        calls.append(("fwd", tuple(rhs.shape)))
        return gm.grouped_matmul_plain(lhs, rhs, sizes)

    def drhs(lhs, dout, sizes):
        calls.append(("drhs", tuple(dout.shape)))
        return gm.grouped_matmul_drhs_plain(lhs, dout, sizes)

    monkeypatch.setattr(gm, "_is_cuda", lambda x: True)
    monkeypatch.setattr(gm, "grouped_matmul_cuda", fwd)
    monkeypatch.setattr(gm, "grouped_matmul_drhs_cuda", drhs)
    return calls


@pytest.mark.parametrize("lhs_grad,rhs_grad", [(True, True), (False, True),
                                               (True, False)])
def test_dispatch_runs_each_kernel_only_where_needed(counting, lhs_grad,
                                                     rhs_grad):
    lhs, rhs = _mk(128, 16, 24, 3, seed=5)
    tl = torch.from_numpy(lhs).requires_grad_(lhs_grad)
    tr = torch.from_numpy(rhs).requires_grad_(rhs_grad)
    out = gm.grouped_matmul(tl, tr, [50, 30, 48])
    np.testing.assert_allclose(out.detach().numpy(),
                               _reference(lhs, rhs, [50, 30, 48]),
                               rtol=FWD_TOL, atol=FWD_TOL)
    out.sum().backward()
    want = [("fwd", (3, 16, 24))]
    if lhs_grad:
        want.append(("fwd", (3, 24, 16)))  # dlhs on rhs^T
    if rhs_grad:
        want.append(("drhs", (128, 24)))
    assert counting == want
    assert (tl.grad is not None) == lhs_grad
    assert (tr.grad is not None) == rhs_grad


def test_checks_raise_and_the_cuda_route_never_falls_back():
    x = torch.zeros((8, 4))
    w = torch.zeros((2, 4, 6))
    with pytest.raises(ValueError, match="K=4"):
        gm.grouped_matmul(x, torch.zeros((2, 5, 6)), [4, 4])
    with pytest.raises(ValueError, match="group_sizes"):
        gm.grouped_matmul(x, w, [8])
    with pytest.raises(TypeError, match="integer"):
        gm.grouped_matmul(x, w, torch.tensor([4.0, 4.0]))
    with pytest.raises(ValueError, match="cuda tensors"):
        gm.grouped_matmul_cuda(x, w, torch.tensor([4, 4]))
    with pytest.raises(ValueError, match="cuda tensors"):
        gm.grouped_matmul_drhs_cuda(x, torch.zeros((8, 6)),
                                    torch.tensor([4, 4]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gm.grouped_matmul(x.to("meta"), w.to("meta"),
                          torch.tensor([4, 4], device="meta"))


def test_kernel_views_and_offsets():
    w = torch.zeros((2, 4, 6))
    wt = w.transpose(1, 2)
    assert gm._unit_view(wt) is wt                 # read in place
    odd = torch.zeros((2, 4, 6, 2))[..., 0]       # no unit stride
    assert gm._unit_view(odd).is_contiguous()
    offs = gm._offsets(torch.tensor([3, 0, 5], dtype=torch.int32))
    assert offs.dtype == torch.int32 and offs.tolist() == [0, 3, 3, 8]
