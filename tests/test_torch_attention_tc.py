"""The arithmetic of the tensor-core kernels K1 and K3 (tile regime) and
the decomposition of K3's split regime, held against the reference.

The CUDA kernels run only on the card (``chip_smoke.py`` compares them
with their plain versions there). Here:

(a) the TF32 rounding and the hi / lo split the kernels use
    (``tests/torch_port_utils.py``, an emulation of ``cvt.rna.tf32.f32``);
(b) attention computed with the kernels' split products (3xTF32 for f32
    operands, 2xTF32 where one operand is exact in TF32) against the JAX
    reference ``_sdpa_reference`` and ``_paged_attention_op`` within f32
    tolerance, and one-pass TF32 outside it;
(c) the plain version of the split-KV decomposition against
    ``paged_attention_plain`` and the Pallas kernel in interpret mode;
(d) the wrapper's regime choice and split count.
All inputs are made with numpy from a seed.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as PF
from paddle_tpu.framework.op import raw
from paddle_tpu.nn.functional.attention import _sdpa_reference
from paddle_tpu.ops.pallas import paged_attention as pa_kernel
from paddle_tpu_torch.inference.engine import EngineConfig
from paddle_tpu_torch.ops import paged_attention as tpa
from torch_port_utils import tf32_matmul, tf32_round, tf32_split

# f32 attention outputs of O(1): the reference and the emulation sum in
# other orders (and the emulation's products drop lo.lo, < 2^-22
# relative), a few f32 ulps; one TF32 pass (2^-11 relative per operand)
# is ~1e-3 off
F32_ATOL = 2e-5


# -- (a) rounding ---------------------------------------------------------

def test_tf32_round_clears_low_mantissa_bits_and_ties_away():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) *
                         np.float32(10.0) ** rng.integers(-8, 8, 4096))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi is the nearest TF32 value: within half a TF32 ulp (2^-11)
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    # hi + lo reconstructs x to 2^-21 relative (the tensor core reads lo
    # to TF32, within 2^-10 of itself, and |lo| <= 2^-11 |x|)
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert (err <= x.abs().double() * 2.0 ** -21).all()
    # ties round away from zero: 1 + 2^-11 -> 1 + 2^-10, and for -x
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert tf32_round(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                        1.0]


def test_bf16_and_int8_values_are_exact_in_tf32():
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 100
                         ).bfloat16().float()
    i8 = torch.arange(-128, 128, dtype=torch.int8).float()
    for x in (b, i8):
        assert torch.equal(tf32_round(x), x)
        hi, lo = tf32_split(x)
        assert torch.equal(hi, x) and not lo.any()


# -- (b) split arithmetic against the reference ---------------------------

def _attn_emulated(q, k, v, scale, passes_qk, passes_pv, causal):
    """[B, H, T, D] attention with both products on emulated TF32 and the
    softmax in f32 (the kernels' online softmax is exact algebra on top)."""
    s = tf32_matmul(q, k.transpose(-1, -2), passes_qk) * scale
    if causal:
        tq, tk = s.shape[-2:]
        keep = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return tf32_matmul(p, v, passes_pv)


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_flash_forward_matches_sdpa_reference(causal):
    """K1 in f32: Q.K^T and P.V each as three TF32 products."""
    rng = np.random.default_rng(2)
    b, t, h, d = 2, 48, 2, 64
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(_sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), None, 0.0, causal,
                                      scale))
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]

    def run(passes):
        return _attn_emulated(*heads, scale, passes, passes,
                              causal).transpose(1, 2).numpy()

    err3 = np.abs(run(3) - want).max()
    err1 = np.abs(run(1) - want).max()
    assert err3 <= F32_ATOL, err3
    # one TF32 pass misses the f32 tolerance by two orders of magnitude:
    # why the kernels split
    assert err1 > 10 * F32_ATOL, err1


def _paged_case(rng, kv, *, s=3, t=2, hkv=2, group=2, p=16, mp=9, d=32):
    h = hkv * group
    n = 1 + s * mp
    q = rng.standard_normal((s, t, h, d)).astype(np.float32)
    ctx = rng.integers(t, mp * p + 1, size=s)
    table = np.zeros((s, mp), np.int32)
    perm = rng.permutation(np.arange(1, n))
    nxt = 0
    for i in range(s):
        used = -(-int(ctx[i]) // p)
        table[i, :used] = perm[nxt:nxt + used]
        nxt += used
    ks = vs = None
    if kv == "int8":
        kp = rng.integers(-127, 128, (n, hkv, p, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (n, hkv, p, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (n, hkv, p)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (n, hkv, p)).astype(np.float32)
    else:
        kp = rng.standard_normal((n, hkv, p, d)).astype(np.float32)
        vp = rng.standard_normal((n, hkv, p, d)).astype(np.float32)
        if kv == "bf16":  # values exactly representable on both sides
            kp = torch.from_numpy(kp).bfloat16().float().numpy()
            vp = torch.from_numpy(vp).bfloat16().float().numpy()
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, table=table,
                start=(ctx - t).astype(np.int32))


def _paged_emulated(c, passes):
    """The tile regime's arithmetic: q.k with q split (k exact in TF32
    for bf16 / int8 pools, else split too), the int8 k scale on the
    logit, the softmax, the v scale on p, p.v with p split."""
    q = torch.from_numpy(c["q"])
    s_, t, h, d = q.shape
    kp, vp = torch.from_numpy(c["kp"]).float(), torch.from_numpy(c["vp"]
                                                                 ).float()
    hkv, p = kp.shape[1], kp.shape[2]
    table = torch.from_numpy(c["table"]).long()
    mp = table.shape[1]

    def gather(x):  # [S, Hkv, K, ...]
        return x[table].transpose(1, 2).reshape(s_, hkv, mp * p,
                                                *x.shape[3:])

    k, v = gather(kp), gather(vp)
    qf = q.reshape(s_, t, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    logits = tf32_matmul(qf, k[:, :, None].transpose(-1, -2), passes)
    logits = logits / math.sqrt(d)
    if c["ks"] is not None:
        logits = logits * gather(torch.from_numpy(c["ks"]))[:, :, None, None]
    qpos = torch.from_numpy(c["start"]).long()[:, None] + torch.arange(t)
    mask = torch.arange(mp * p)[None, None] <= qpos[:, :, None]
    logits = logits.masked_fill(~mask[:, None, None], tpa.mask_fill_value())
    prob = torch.softmax(logits, -1)
    if c["vs"] is not None:
        prob = prob * gather(torch.from_numpy(c["vs"]))[:, :, None, None]
    out = tf32_matmul(prob, v[:, :, None], passes)
    return out.permute(0, 3, 1, 2, 4).reshape(s_, t, h, d).numpy()


@pytest.mark.parametrize("kv, passes", [("f32", 3), ("bf16", 2),
                                        ("int8", 2)])
def test_split_tf32_paged_attention_matches_reference_op(kv, passes):
    """K3's tile regime: 2xTF32 over bf16 / int8 pools (exact in TF32),
    3xTF32 over an f32 pool, against ``_paged_attention_op``."""
    rng = np.random.default_rng(3 + passes)
    c = _paged_case(rng, kv, d=64)
    pool = (lambda x: jnp.asarray(x, jnp.bfloat16)) if kv == "bf16" else \
        jnp.asarray
    want = np.asarray(raw(PF.paged_attention(
        jnp.asarray(c["q"]), pool(c["kp"]), pool(c["vp"]),
        jnp.asarray(c["table"]), jnp.asarray(c["start"]), kernel="einsum",
        k_scales=None if c["ks"] is None else jnp.asarray(c["ks"]),
        v_scales=None if c["vs"] is None else jnp.asarray(c["vs"]))),
        np.float32)
    err = np.abs(_paged_emulated(c, passes) - want).max()
    assert err <= F32_ATOL, err
    # one TF32 pass (q rounded to 10 bits) misses the f32 tolerance
    err1 = np.abs(_paged_emulated(c, 1) - want).max()
    assert err1 > 5 * F32_ATOL, err1


# -- (c) split-KV decomposition -------------------------------------------

def _torch_args(c, kv):
    conv = {"f32": lambda x: torch.from_numpy(x),
            "bf16": lambda x: torch.from_numpy(x).bfloat16(),
            "int8": lambda x: torch.from_numpy(x)}[kv]
    args = (torch.from_numpy(c["q"]), conv(c["kp"]), conv(c["vp"]),
            torch.from_numpy(c["table"]), torch.from_numpy(c["start"]))
    kw = dict(k_scales=None if c["ks"] is None else torch.from_numpy(c["ks"]),
              v_scales=None if c["vs"] is None else torch.from_numpy(c["vs"]))
    return args, kw


def _pallas(c, kv):
    pool = (lambda x: jnp.asarray(x, jnp.bfloat16)) if kv == "bf16" else \
        jnp.asarray
    return np.asarray(pa_kernel.paged_attention(
        jnp.asarray(c["q"]), pool(c["kp"]), pool(c["vp"]),
        jnp.asarray(c["table"]), jnp.asarray(c["start"]), interpret=True,
        k_scales=None if c["ks"] is None else jnp.asarray(c["ks"]),
        v_scales=None if c["vs"] is None else jnp.asarray(c["vs"])))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("group", [1, 2])
def test_split_decomposition_matches_plain_and_pallas(kv, group):
    """Ragged contexts over a 144-key table (3 splits of 64): short
    slots leave whole splits past their horizon (l = 0 partials); an
    idle slot reads only the trash page 0 (start 0, table all zero)."""
    rng = np.random.default_rng(10 * group + {"f32": 0, "bf16": 1,
                                              "int8": 2}[kv])
    c = _paged_case(rng, kv, s=4, t=1 if group == 2 else 3, group=group)
    c["start"][0] = 3      # ends inside the first split
    c["table"][3] = 0      # idle slot on the trash page
    c["start"][3] = 0
    args, kw = _torch_args(c, kv)
    got = tpa.paged_attention_split_plain(*args, **kw)
    ref = tpa.paged_attention_plain(*args, **kw)
    assert tpa._k3_splits(c["table"].shape[1], 16) == 3
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=F32_ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _pallas(c, kv), atol=F32_ATOL,
                               rtol=1e-5)


def test_split_decomposition_all_masked_rows_emit_zeros_as_pallas():
    """A slot whose rows see no key (start -2, table on the trash page):
    every split is an l = 0 partial and the merge emits zeros, as the
    Pallas kernel does (the dense plain softmax would average instead)."""
    rng = np.random.default_rng(30)
    c = _paged_case(rng, "bf16", s=2, t=2, group=2)
    c["table"][1] = 0
    c["start"][1] = -2
    args, kw = _torch_args(c, "bf16")
    got = tpa.paged_attention_split_plain(*args, **kw).numpy()
    assert not got[1].any()
    np.testing.assert_allclose(got, _pallas(c, "bf16"), atol=F32_ATOL,
                               rtol=1e-5)


# -- (d) regime choice ------------------------------------------------------

def test_regime_choice_and_split_count():
    cfg = EngineConfig(num_slots=8, max_length=1024, page_size=16,
                       speculate_k=4)
    # every prefill bucket of the served configuration runs tiles
    assert all(tpa._k3_regime(b, 1) == "tile"
               for b in cfg.resolved_buckets())
    # decode (T=1) and verify (T=k+1) at G=1 run splits
    assert tpa._k3_regime(1, 1) == "split"
    assert tpa._k3_regime(cfg.speculate_k + 1, 1) == "split"
    # wide GQA verify has enough rows for tiles
    assert tpa._k3_regime(5, 4) == "tile"
    # the split count follows the table width MP * P only
    assert tpa._k3_splits(64, 16) == 16
    assert tpa._k3_splits(9, 16) == 3
    assert tpa._k3_splits(1, 4) == 1


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(31)
    names = ("launches", "launches_tile", "launches_split",
             "launches_decode", "launches_verify")
    before = [getattr(tpa, n) for n in names]
    for t in (1, 5, 20):
        c = _paged_case(rng, "f32", s=2, t=t, group=1)
        args, kw = _torch_args(c, "f32")
        got = tpa.paged_attention(*args, **kw)
        torch.testing.assert_close(got, tpa.paged_attention_plain(*args),
                                   rtol=0, atol=0)
    assert [getattr(tpa, n) for n in names] == before


def test_split_keys_match_the_kernel_source():
    # the wrapper sizes the split count with SPLIT_KEYS and the C entry
    # refuses any count but ceil(MP * P / kSplitKeys): they must agree
    src = (Path(tpa.__file__).parent / "cuda" / "paged_attention.cu"
           ).read_text()
    found = re.search(r"constexpr int kSplitKeys = (\d+);", src)
    assert found is not None and int(found.group(1)) == tpa.SPLIT_KEYS
