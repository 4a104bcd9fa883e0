"""The tile walk and tensor-core arithmetic of the grouped-matmul kernels
K4a (forward, and dlhs on the ``rhs^T`` view) and K4b (drhs), held against
the plain versions and the Pallas kernel.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 9 holds
them against their plain versions there). Here a torch emulation walks
their blocks as they do:

- K4a: blocks in bands of ``GROUP_M`` row tiles (``raster``), each block a
  BM x BN output tile that finds its first group by a binary search of the
  offsets and makes one pass over K for each group it meets, rows outside
  the group (and the padding tail) zero-filled, K in steps of the ring's
  depth with a zero-filled tail;
- K4b: a block per (group, k tile, n tile) walking the group's rows in
  steps of the depth from the group's first row, the rows past the group
  zero-filled, an empty group writing zeros;

with every product as the kernels take it (``tests/torch_port_utils.py``):
f32 as three TF32 products of the truncating hi / lo split
(``tf32_matmul(..., split="trunc")``), bf16 as exact products summed in
f32. The tile sizes are read from the kernel source, and the wrapper's
16-byte load predicate is checked on f32 and bf16 views.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.grouped_matmul import grouped_matmul as ref_gmm
from paddle_tpu_torch.ops import grouped_matmul as gm
from torch_port_utils import tf32_matmul

# max|err| / max|ref|, chip_smoke.py's GMM_TOL: f32 sums of exact TF32
# products (the split reads each operand to 2^-20) against f32 sums in
# another order; a bf16 output is rounded to bf16 on both sides (one ulp is
# 2^-8 relative); drhs stays f32 in both dtypes
TOL = {"f32": 1e-5, "bf16": 2 ** -7}

CUDA = Path(gm.__file__).parent / "cuda"
# the kernels' tiles (rows, columns, reductions a ring stage) by dtype and
# K4a's raster band, pinned to the source below
TILES = {"f32": {"fwd": (128, 128, 32), "drhs": (128, 128, 32)},
         "bf16": {"fwd": (128, 256, 64), "drhs": (128, 256, 64)}}
GROUP_M = 8


def _product(a, b, dtype, passes):
    """a @ b of one ring stage as the tensor cores take it, f32."""
    if dtype == "bf16":  # bf16 x bf16 is exact; sums in f32
        return (a.double() @ b.double()).float()
    return tf32_matmul(a, b, passes, split="trunc")


def raster(bid, mt, nt):
    """grouped_matmul.cu::raster: block bid's (row tile, column tile)."""
    per_band = GROUP_M * nt
    band, i = divmod(bid, per_band)
    first = band * GROUP_M
    rows = min(mt - first, GROUP_M)
    return first + i % rows, i // rows


def first_group(offs, m0):
    """The first group whose rows end past m0 (binary search)."""
    lo, hi = 0, len(offs) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if offs[mid + 1] > m0:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _tile(x, rows, cols):
    """x[rows, cols] zero-filled outside x (a ring stage's cp.async)."""
    out = torch.zeros(rows.stop - rows.start, cols.stop - cols.start,
                      dtype=x.dtype)
    r = slice(rows.start, min(rows.stop, x.shape[0]))
    c = slice(cols.start, min(cols.stop, x.shape[1]))
    if r.stop > r.start and c.stop > c.start:
        out[:r.stop - r.start, :c.stop - c.start] = x[r, c]
    return out.float()


def k4a_emulated(lhs, rhs, offs, dtype, passes):
    """K4a's walk: [M, N] in lhs's dtype. rhs may be the rhs^T view."""
    bm, bn, depth = TILES[dtype]["fwd"]
    m, k = lhs.shape
    n = rhs.shape[2]
    mt, nt = -(-m // bm), -(-n // bn)
    out = torch.full((m, n), float("nan"))
    seen = set()
    for bid in range(mt * nt):
        mi, ni = raster(bid, mt, nt)
        seen.add((mi, ni))
        m0, n0 = mi * bm, ni * bn
        m_end = min(m0 + bm, m)
        acc = torch.zeros(bm, bn)
        for g in range(first_group(offs, m0), len(offs) - 1):
            if offs[g] >= m_end:
                break
            rs, re_ = max(offs[g], m0), min(offs[g + 1], m_end)
            if rs >= re_:
                continue  # empty group
            rows = torch.zeros(m, dtype=lhs.dtype)  # the visit's row mask
            rows[rs:re_] = 1
            masked = lhs * rows[:, None]
            for k0 in range(0, k, depth):
                a = _tile(masked, slice(m0, m0 + bm), slice(k0, k0 + depth))
                b = _tile(rhs[g], slice(k0, k0 + depth), slice(n0, n0 + bn))
                acc += _product(a, b, dtype, passes)
        out[m0:m_end, n0:n0 + bn] = acc[:m_end - m0, :n - n0]
    assert seen == {(i, j) for i in range(mt) for j in range(nt)}
    return out.to(lhs.dtype)


def k4b_emulated(lhs, dout, offs, dtype, passes):
    """K4b's walk: drhs [G, K, N] f32."""
    bm, bn, depth = TILES[dtype]["drhs"]
    m, k = lhs.shape
    n = dout.shape[1]
    drhs = torch.full((len(offs) - 1, k, n), float("nan"))
    for g in range(len(offs) - 1):
        rs, re_ = min(offs[g], m), min(offs[g + 1], m)
        rows = torch.zeros(m, dtype=lhs.dtype)
        rows[rs:re_] = 1
        a_src, b_src = lhs * rows[:, None], dout * rows[:, None]
        for k0 in range(0, k, bm):
            for n0 in range(0, n, bn):
                acc = torch.zeros(bm, bn)
                for r0 in range(rs, re_, depth):  # empty group: no step
                    a = _tile(a_src, slice(r0, r0 + depth),
                              slice(k0, k0 + bm))
                    b = _tile(b_src, slice(r0, r0 + depth),
                              slice(n0, n0 + bn))
                    acc += _product(a.T.contiguous(), b, dtype, passes)
                drhs[g, k0:k0 + bm, n0:n0 + bn] = acc[:min(bm, k - k0),
                                                      :min(bn, n - n0)]
    return drhs


# (sizes, M, K, N): aligned, ragged with several k steps, empty groups, a
# padding tail, odd K and N, and several row and column tiles of both
# dtypes with a trailing empty group. M is a multiple of 64 (the Pallas
# kernel's block_m).
CASES = {
    "aligned": ([64, 64], 128, 32, 64),
    "ragged": ([50, 30, 48], 128, 80, 88),
    "empty-groups": ([0, 100, 0, 28], 128, 32, 64),
    "padding-tail": ([30, 40], 128, 48, 56),
    "odd-k-and-n": ([100, 0, 61], 192, 45, 53),
    "multi-tile": ([100, 156, 40, 0], 320, 136, 272),
}


def _arr(rng, shape, dtype):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16() if dtype == "bf16" else x


def _case(name, dtype):
    sizes, m, k, n = CASES[name]
    rng = np.random.default_rng(60 + sorted(CASES).index(name))
    lhs = _arr(rng, (m, k), dtype)
    rhs = _arr(rng, (len(sizes), k, n), dtype)
    dout = _arr(rng, (m, n), dtype)
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return sizes, lhs, rhs, dout, offs


def _rel(got, want):
    got, want = (np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                            np.float32) for x in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _emulate(lhs, rhs, dout, offs, dtype, passes):
    return dict(out=k4a_emulated(lhs, rhs, offs, dtype, passes),
                dlhs=k4a_emulated(dout, rhs.transpose(1, 2), offs, dtype,
                                  passes),
                drhs=k4b_emulated(lhs, dout, offs, dtype, passes))


def _pallas(lhs, rhs, dout, sizes):
    """out, dlhs, drhs of the Pallas kernel (interpret mode) and its
    custom VJP; dlhs and drhs leave in the inputs' dtype."""
    def to_j(x):
        return jnp.asarray(x.float().numpy(), (
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32))

    sz = jnp.asarray(sizes, jnp.int32)
    out, vjp = jax.vjp(lambda a, b: ref_gmm(a, b, sz, block_m=64,
                                            interpret=True),
                       to_j(lhs), to_j(rhs))
    dlhs, drhs = vjp(to_j(dout))
    return {k: np.asarray(v, np.float32)
            for k, v in dict(out=out, dlhs=dlhs, drhs=drhs).items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_walk_matches_plain_and_pallas(name, dtype):
    sizes, lhs, rhs, dout, offs = _case(name, dtype)
    got = _emulate(lhs, rhs, dout, offs, dtype, 3)
    st = torch.tensor(sizes)
    plain = dict(out=gm.grouped_matmul_plain(lhs, rhs, st),
                 dlhs=gm.grouped_matmul_plain(dout, rhs.transpose(1, 2), st),
                 drhs=gm.grouped_matmul_drhs_plain(lhs, dout, st))
    tol = dict(out=TOL[dtype], dlhs=TOL[dtype], drhs=TOL["f32"])
    total = offs[-1]
    for what in ("out", "dlhs"):
        assert got[what].dtype == lhs.dtype
        assert not got[what][total:].float().any()  # the padding tail
    assert got["drhs"].dtype == torch.float32
    for g, size in enumerate(sizes):
        if size == 0:  # an empty group's drhs
            assert not got["drhs"][g].any()
    for what in ("out", "dlhs", "drhs"):
        err = _rel(got[what], plain[what])
        assert err <= tol[what], (what, err)
    if dtype == "f32" or name in ("multi-tile", "odd-k-and-n"):
        ref = _pallas(lhs, rhs, dout, sizes)
        # the Pallas VJP casts drhs to rhs's dtype
        tol["drhs"] = TOL[dtype]
        for what in ("out", "dlhs", "drhs"):
            err = _rel(got[what], ref[what])
            assert err <= tol[what], (what, err)


def test_one_tf32_pass_misses_the_tolerance():
    """Why f32 takes three products: one TF32 pass (operands read to
    2^-10) lands ~1e-3 off at K = 1024, far outside the f32 tolerance,
    where the split stays inside it."""
    rng = np.random.default_rng(7)
    sizes, m, k, n = [60, 68], 128, 1024, 64
    lhs = _arr(rng, (m, k), "f32")
    rhs = _arr(rng, (2, k, n), "f32")
    offs = [0, 60, 128]
    want = gm.grouped_matmul_plain(lhs, rhs, torch.tensor(sizes))
    one = _rel(k4a_emulated(lhs, rhs, offs, "f32", 1), want)
    split = _rel(k4a_emulated(lhs, rhs, offs, "f32", 3), want)
    assert split <= TOL["f32"] < 10 * TOL["f32"] < one, (split, one)


def test_tile_sizes_match_the_kernel_source():
    src = (CUDA / "grouped_matmul.cu").read_text()

    def const(name):
        found = re.search(rf"\b{name} = (\d+)[,;]", src)
        assert found is not None, name
        return int(found.group(1))

    assert const("kGroupM") == GROUP_M
    for kind, key in (("fwd", "Fwd"), ("drhs", "Drhs")):
        assert TILES["bf16"][kind] == (const("kBf16TileM"),
                                       const(f"kBf16{key}N"),
                                       const("kBf16Depth")), kind
        assert TILES["f32"][kind] == (const("kF32TileM"), const("kF32TileN"),
                                      const("kF32Depth")), kind
    assert gm._TILE == const("kBf16TileM") == const("kF32TileM")


def test_vec_predicate_takes_whole_16_byte_chunks():
    f32 = torch.zeros(64, 36)
    bf = torch.zeros(64, 40, dtype=torch.bfloat16)
    assert gm._vec(36, 36, (f32, 1))             # 4 f32 a chunk
    assert not gm._vec(36, 36, (f32.bfloat16(), 1))  # 8 bf16 a chunk
    assert gm._vec(40, 40, (bf, 1))
    assert not gm._vec(40, 36, (bf, 1))           # N off the chunk
    w = torch.zeros(2, 40, 48, dtype=torch.bfloat16)
    assert gm._vec(48, 40, (w.transpose(1, 2), 1))   # the rhs^T view
    assert not gm._vec(48, 40, (w.transpose(1, 2), 2))
    assert not gm._vec(40, 40, (bf[:, 1:], 1))    # base off 16 bytes
    assert not gm._vec(40, 40, (bf[:, ::2], 1))   # no unit stride
    odd_rows = torch.zeros(64, 44, dtype=torch.bfloat16)[:, :40]
    assert not gm._vec(40, 40, (odd_rows, 1))     # row stride 44


def test_design_variants_apply_to_the_kernel_source():
    """scripts/gmm_variants.py edits the source by text substitution: each
    variant's text must still be there, and each variant must change the
    source."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / "gmm_variants.py"
    spec = importlib.util.spec_from_file_location("gmm_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    shipped = variants.source("shipped")
    for name in variants.VARIANTS:
        if name != "shipped":
            assert variants.source(name) != shipped, name
