"""The decomposition of the tensor-core backward kernels K2a (dQ) and K2b
(dK / dV), held against the plain versions and the Pallas backward.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 6a holds
them against their plain versions there). Here a torch emulation walks
their tiles as they do:

- K2a: a block of 64 query rows (16 a warp) walks key tiles up to the
  block's causal horizon (``key_end``), each warp skipping the tiles past
  its own; per tile S = Q.K^T and dP = dO.V^T, P = exp(s - lse) gated at
  NEG_INF / 2, dS = P (dP - delta), dS into the dbias plane, dQ += dS.K;
- K2b: a block of 64 key rows (16 a warp) walks query tiles from the first
  that sees it (``q_begin``), each warp skipping the tiles before its own
  first query; per tile the transposed products S^T = K.Q^T and
  dP^T = V.dO^T, the transposed causal mask (key kj is visible to query
  qi iff kj <= qi + Tk - Tq), lse and delta indexed by column, then
  dV += P^T.dO and dK += dS^T.Q;

with ragged tails at both ends, and every product as the kernels take it
(``tests/torch_port_utils.py``): f32 3xTF32 with the backward's truncating
split; bf16 S and dP exact (bf16 products, f32 sums), the products with P
or dS 2xTF32. The tile sizes are read from the kernel source. Inputs are
made with numpy from a seed; bf16 cases use values exact in bf16, handed
to every side as f32.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as ref
from paddle_tpu_torch.ops import flash_attention as fa
from torch_port_utils import tf32_matmul

# f32 gradients, as max|err| / max|ref|: the plain version and the Pallas
# kernel sum in f32 in other orders, the emulation sums exact TF32
# products (the split reads each operand to 2^-20, and drops lo.lo, below
# 2^-20 of a product); dS = P (dP - delta) cancels, so a few f32 ulps of
# its terms show up relative to max|dK|. One TF32 pass (2^-10) is ~1e-3 off.
TOL = 2e-5

CUDA = Path(fa.__file__).parent / "cuda"
# the emulation's tiles: rows of a block (16 a warp), K2a's key tile and
# K2b's query tile by dtype (pinned to the source below)
ROWS = 64
WARP_ROWS = 16
DQ_BK = {"f32": 32, "bf16": 64}
DKV_BQ = {"f32": 16, "bf16": 32}


def _qk(a, b, dtype, passes):
    """a . b^T as K2a / K2b's qk2 products compute it."""
    if dtype == "bf16" and passes != 1:  # bf16 x bf16: exact, f32 sums
        return (a.double() @ b.double().T).float()
    return tf32_matmul(a, b.T, passes, split="trunc")


def _pv(p, x, dtype, passes):
    """p . x (p an f32 P or dS fragment, x a stored tile) as pv_tf32."""
    n = 2 if dtype == "bf16" and passes != 1 else passes
    return tf32_matmul(p, x, n, split="trunc")


def _bias_full(bias, b, h, tq, tk):
    if bias is None:
        return torch.zeros(b, h, tq, tk)
    return bias.expand(b, h, tq, tk)


def _masked(s, bias_tile, vis, scale):
    """(q.k) * scale + bias, NEG_INF where the key is not visible."""
    return torch.where(vis, s * scale + bias_tile,
                       torch.tensor(fa.NEG_INF))


def _visible(rows, cols, causal):
    """K2a's mask: key cols[j] visible to query rows[i] (bottom-right
    causal; tq - tk folded into the caller's offset)."""
    if not causal:
        return torch.ones(len(rows), len(cols), dtype=torch.bool)
    return cols[None, :] <= rows[:, None]


def _p(x, lse):
    return torch.where(x > fa.NEG_INF * 0.5, torch.exp(x - lse), 0.0)


def k2a_emulated(q, k, v, bias, do, lse, delta, causal, scale, dtype,
                 passes):
    """K2a's tile walk: dQ [B, Tq, H, D] f32 and the dS plane
    [B, H, Tq, Tk] (zero on tiles no warp visits)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    bk = DQ_BK[dtype]
    bias4 = _bias_full(bias, b, h, tq, tk)
    dq = torch.zeros(b, tq, h, d)
    ds_plane = torch.zeros(b, h, tq, tk)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // hkv)
            for q0 in range(0, tq, ROWS):
                k_end = min(tk, q0 + ROWS + tk - tq) if causal else tk
                for k0 in range(0, max(k_end, 0), bk):
                    kr = slice(k0, min(k0 + bk, tk))
                    kj = torch.arange(k0, kr.stop)
                    for w0 in range(q0, min(q0 + ROWS, tq), WARP_ROWS):
                        w_end = (min(tk, w0 + WARP_ROWS + tk - tq) if causal
                                 else tk)
                        if k0 >= w_end:  # every key masked for the warp
                            continue
                        wr = slice(w0, min(w0 + WARP_ROWS, tq))
                        qi = torch.arange(w0, wr.stop)
                        s = _qk(q[bi, wr, hi], k[bi, kr, kv], dtype, passes)
                        dp = _qk(do[bi, wr, hi], v[bi, kr, kv], dtype,
                                 passes)
                        vis = _visible(qi + (tk - tq), kj, causal)
                        x = _masked(s, bias4[bi, hi, wr, kr], vis, scale)
                        ds = (_p(x, lse[bi, hi, wr, None])
                              * (dp - delta[bi, hi, wr, None]))
                        ds_plane[bi, hi, wr, kr] = ds
                        dq[bi, wr, hi] += _pv(ds, k[bi, kr, kv], dtype,
                                              passes)
    return dq * scale, ds_plane


def k2b_emulated(q, k, v, bias, do, lse, delta, causal, scale, dtype,
                 passes):
    """K2b's tile walk: dK, dV per query head, f32 [B, Tk, H, D]."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    bq = DKV_BQ[dtype]
    bias4 = _bias_full(bias, b, h, tq, tk)
    dk = torch.zeros(b, tk, h, d)
    dv = torch.zeros(b, tk, h, d)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // hkv)
            for k0 in range(0, tk, ROWS):
                q_begin = 0
                if causal:  # the first query that sees key k0, tile-aligned
                    first = k0 - (tk - tq)
                    q_begin = first // bq * bq if first > 0 else 0
                for q0 in range(q_begin, tq, bq):
                    qr = slice(q0, min(q0 + bq, tq))
                    qi = torch.arange(q0, qr.stop)
                    for kw in range(k0, min(k0 + ROWS, tk), WARP_ROWS):
                        w_first = kw - (tk - tq) if causal else 0
                        if q0 + bq <= w_first:  # no query sees the warp's
                            continue
                        kr = slice(kw, min(kw + WARP_ROWS, tk))
                        kj = torch.arange(kw, kr.stop)
                        st = _qk(k[bi, kr, kv], q[bi, qr, hi], dtype, passes)
                        dpt = _qk(v[bi, kr, kv], do[bi, qr, hi], dtype,
                                  passes)
                        # transposed: rows are keys, columns queries;
                        # key kj is visible to query qi iff
                        # kj <= qi + Tk - Tq
                        vis_t = torch.ones(st.shape, dtype=torch.bool)
                        if causal:
                            vis_t = kj[:, None] <= qi[None, :] + (tk - tq)
                        xt = _masked(st, bias4[bi, hi, qr, kr].T, vis_t,
                                     scale)
                        pt = _p(xt, lse[bi, hi, None, qr])
                        dst = pt * (dpt - delta[bi, hi, None, qr])
                        dv[bi, kr, hi] += _pv(pt, do[bi, qr, hi], dtype,
                                              passes)
                        dk[bi, kr, hi] += _pv(dst, q[bi, qr, hi], dtype,
                                              passes)
    return dk * scale, dv


def _arr(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bf16":  # values exactly representable in bf16
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _fold(x):  # [B, T, H, D] -> [B*H, T, D]
    return jnp.swapaxes(x, 1, 2).reshape(-1, x.shape[1], x.shape[-1])


def _unfold(x, b):  # [B*H, T, D] -> [B, T, H, D]
    x = np.array(x, np.float32)
    return x.reshape(b, -1, *x.shape[1:]).transpose(0, 2, 1, 3).copy()


# (causal, Tq, Tk, H, Hkv, bias dims or None, bias grad, dtype); bias dims
# B, H, Q (Tq), K (Tk) or 1. Sizes give several tiles of both kernels with
# ragged tails at D = 64.
CASES = {
    "causal-tq<tk-gqa-padbias": (True, 70, 100, 4, 2, "B11K", True, "f32"),
    "causal-tq>tk-deadrows": (True, 100, 70, 2, 1, None, False, "f32"),
    "full-headbias-maskedrow": (False, 80, 90, 2, 2, "1HQK", True, "f32"),
    "causal-bf16-gqa": (True, 96, 96, 4, 2, None, False, "bf16"),
}


def _case(name):
    causal, tq, tk, h, hkv, bcode, bgrad, dt = CASES[name]
    b, d = 2, 64
    rng = np.random.default_rng(40 + sorted(CASES).index(name))
    q = _arr(rng, (b, tq, h, d), dt)
    k = _arr(rng, (b, tk, hkv, d), dt)
    v = _arr(rng, (b, tk, hkv, d), dt)
    do = _arr(rng, (b, tq, h, d), dt)
    bias = None
    if bcode is not None:
        dims = tuple({"B": b, "H": h, "Q": tq, "K": tk, "1": 1}[c]
                     for c in bcode)
        bias = rng.standard_normal(dims).astype(np.float32)
        if bcode == "1HQK":
            bias[0, 1, 5, :] = fa.NEG_INF  # a row with no visible key
    return dict(causal=causal, bgrad=bgrad, dtype=dt, q=q, k=k, v=v, do=do,
                bias=bias, b=b, h=h, hkv=hkv, scale=1.0 / math.sqrt(d))


def _reference(c):
    """The Pallas forward and backward in interpret mode (one block a
    head: interpret mode is slow):
    o, lse [B, H, Tq], dq, dk, dv [B, T, H, D] and dbias."""
    b, h, hkv = c["b"], c["h"], c["hkv"]
    tq = c["q"].shape[1]
    rbias, bb, bh = None, 1, 1
    if c["bias"] is not None:
        bb, bh = c["bias"].shape[:2]
        rbias = jnp.asarray(c["bias"]).reshape(bb * bh, *c["bias"].shape[2:])
    jq, jk, jv, jdo = (_fold(jnp.asarray(c[n])) for n in ("q", "k", "v",
                                                          "do"))
    o, lse = ref._fa_forward(jq, jk, jv, rbias, c["causal"], c["scale"], h,
                             hkv, bb, bh, 128, 128, True)
    dq, dk, dv, dbias = ref._fa_backward(
        jq, jk, jv, rbias, o, lse, jdo, c["causal"], c["scale"], h, hkv, bb,
        bh, c["bgrad"], 128, 128, True)
    return dict(o=_unfold(o, b),
                lse=np.array(lse)[:, :tq].reshape(b, h, tq),
                dq=_unfold(dq, b), dk=_unfold(dk, b), dv=_unfold(dv, b),
                dbias=None if dbias is None else np.asarray(dbias).reshape(
                    c["bias"].shape))


@pytest.fixture(scope="module")
def cases():
    """Each case's inputs and its Pallas reference (interpret mode is
    slow: built once for the module)."""
    return {name: (c, _reference(c)) for name, c in
            ((n, _case(n)) for n in sorted(CASES))}


def _emulate(c, r, passes):
    t = {n: torch.from_numpy(c[n]) for n in ("q", "k", "v", "do")}
    bias = None if c["bias"] is None else torch.from_numpy(c["bias"])
    lse = torch.from_numpy(r["lse"])
    delta = fa._delta(torch.from_numpy(r["o"]), t["do"])
    args = (t["q"], t["k"], t["v"], bias, t["do"])
    dq, ds = k2a_emulated(*args, lse, delta, c["causal"], c["scale"],
                          c["dtype"], passes)
    dk, dv = k2b_emulated(*args, lse, delta, c["causal"], c["scale"],
                          c["dtype"], passes)
    plain_dq, plain_ds = fa.flash_attention_bwd_dq_plain(
        *args, lse, delta, causal=c["causal"], scale=c["scale"],
        want_ds=True)
    plain_dk, plain_dv = fa.flash_attention_bwd_dkv_plain(
        *args, lse, delta, causal=c["causal"], scale=c["scale"])
    return dict(dq=dq, ds=ds, dk=dk, dv=dv), dict(
        dq=plain_dq, ds=plain_ds, dk=plain_dk, dv=plain_dv)


def _group_sum(x, hkv):
    b, t, h, d = x.shape
    return x.reshape(b, t, hkv, h // hkv, d).sum(3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_walk_matches_plain_and_pallas(cases, name):
    c, r = cases[name]
    got, plain = _emulate(c, r, 3)
    for what in ("dq", "ds", "dk", "dv"):
        err = _rel(got[what], plain[what])
        assert err <= TOL, (what, err)
    assert _rel(got["dq"], r["dq"]) <= TOL
    for what in ("dk", "dv"):
        err = _rel(_group_sum(got[what], c["hkv"]), r[what])
        assert err <= TOL, (what, err)
    if c["bgrad"]:
        ds = fa._reduce_bias_grad(got["ds"], torch.from_numpy(c["bias"]))
        assert _rel(ds, r["dbias"]) <= TOL
    if name == "causal-tq>tk-deadrows":  # rows 0-29 see no key
        assert not got["dq"][:, :30].any() and not got["ds"][:, :, :30].any()
    if name == "full-headbias-maskedrow":
        assert not got["dq"][0, 5, 1].any() and not got["ds"][0, 1, 5].any()


def test_one_tf32_pass_misses_the_tolerance(cases):
    """Why the kernels split: with one TF32 pass (operands read to
    2^-10) dQ and dK land ~1e-3 off, far outside TOL."""
    c, r = cases["causal-tq<tk-gqa-padbias"]
    got, plain = _emulate(c, r, 1)
    for what in ("dq", "dk", "dv"):
        err = _rel(got[what], plain[what])
        assert err > 10 * TOL, (what, err)


def test_tile_sizes_match_the_kernel_source():
    src = (CUDA / "flash_attention.cu").read_text()
    tile = (CUDA / "attention_tile.cuh").read_text()
    warps = re.search(r"constexpr int kWarps = (\d+);", tile)
    assert re.search(r"constexpr int kRows = kWarps \* 16;", tile)
    assert warps is not None and 16 * int(warps.group(1)) == ROWS
    for name, sizes in (("kDqBK", DQ_BK), ("kDkvBQ", DKV_BQ)):
        found = re.search(rf"constexpr int {name}F32 = (\d+), "
                          rf"{name}Bf16 = (\d+);", src)
        assert found is not None, name
        assert (int(found.group(1)), int(found.group(2))) == (
            sizes["f32"], sizes["bf16"]), name


def test_design_variants_apply_to_the_kernel_source():
    """scripts/flash_bwd_variants.py edits the source by text
    substitution: each variant's text must still be there, and each
    variant must change the source."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "flash_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_variants",
                                                  path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    shipped = variants.sources("shipped")
    for name in variants.VARIANTS:
        if name != "shipped":
            assert variants.sources(name) != shipped, name
