"""Llama served by the PyTorch port's engine against the reference engine.

The reference ``DecodeEngine`` (einsum attention oracle) and the port's
``DecodeEngine(device="cpu")`` serve the same requests on a bridged tiny
Llama with grouped-query attention (G = 2 and G = 4: the pool holds the kv
heads only, the paged attention folds each group of query heads into its
rows). Greedy token streams must be equal, with f32 and int8 KV pools and
with speculation off and on.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import engine as ref_engine
from paddle_tpu_torch.inference.engine import DecodeEngine
from paddle_tpu_torch.ops import paged_attention as pa

from torch_port_utils import (VOCAB, jax_tiny_llama, numpy_state,
                              torch_tiny_llama)

GEOMETRY = dict(num_slots=3, max_length=64, page_size=4)
NEW_TOKENS = 12


def _prompts():
    """4 mixed-length requests; the first two share two full pages, the
    last is periodic so prompt-lookup drafts exist."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, VOCAB, 8)
    return [np.concatenate([shared, rng.integers(1, VOCAB, 3)]),
            np.concatenate([shared, rng.integers(1, VOCAB, 6)]),
            rng.integers(1, VOCAB, 5),
            np.concatenate([rng.integers(1, VOCAB, 4)] * 3)]


def _serve(engine, prompts, n=NEW_TOKENS):
    rids = [engine.submit(p, max_new_tokens=n) for p in prompts]
    engine.run()
    return [np.asarray(engine.result(r)).tolist() for r in rids]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda g: f"G{g}")
def models(request):
    with jax_tiny_llama(group=request.param) as jm:
        yield jm, torch_tiny_llama(numpy_state(jm), group=request.param)


@pytest.mark.parametrize("kv, k", [("f32", 0), ("f32", 4), ("int8", 0),
                                   ("int8", 4)])
def test_greedy_streams_equal_reference(models, kv, k):
    jm, tm = models
    cfg = dict(GEOMETRY, kv_dtype=kv, speculate_k=k, spec_adaptive=False)
    ref_eng = ref_engine.DecodeEngine(jm, attn_kernel="einsum", **cfg)
    eng = DecodeEngine(tm, device="cpu", **cfg)
    ref = _serve(ref_eng, _prompts())
    got = _serve(eng, _prompts())
    assert got == ref
    assert all(len(g) == len(p) + NEW_TOKENS
               for g, p in zip(got, _prompts()))
    # the pool holds the kv heads only
    cfg_m = tm.config
    assert eng._kc.shape == (cfg_m.num_hidden_layers, eng.pool.num_pages,
                             cfg_m.num_key_value_heads, 4, 8)
    if kv == "int8":
        assert eng._ksc.shape == eng._kc.shape[:-1]
    assert eng.prefix_hit_tokens == ref_eng.prefix_hit_tokens == 8
    assert eng.verify_steps == ref_eng.verify_steps
    assert (k == 0) == (eng.verify_steps == 0)


def test_tail_bucket_past_the_rope_tables(models):
    """A tail prefill whose padded positions pass max_position_embeddings:
    36 cached tokens + a 20-token tail in a 32-token bucket reach position
    67 of a 64-row table. The port clamps the padding rows' RoPE gather;
    the reference fills them with NaN, which its padding rows then write
    to the shared trash page. Served one request at a time (the second
    reads no trash page) the streams agree; served together, the port's
    streams are the same, its pool finite."""
    jm, tm = models
    assert tm.config.max_position_embeddings == GEOMETRY["max_length"]
    rng = np.random.default_rng(3)
    shared = rng.integers(1, VOCAB, 36)
    prompts = [np.concatenate([shared, rng.integers(1, VOCAB, 4)]),
               np.concatenate([shared, rng.integers(1, VOCAB, 20)])]
    cfg = dict(GEOMETRY, kv_dtype="f32")

    def one_by_one(engine):
        return [_serve(engine, [p], n=8)[0] for p in prompts]

    eng = DecodeEngine(tm, device="cpu", **cfg)
    got = one_by_one(eng)
    assert eng.prefix_hit_tokens == 36
    assert eng._bucket_for(20) == 32 and 36 + 32 > 64
    ref = one_by_one(ref_engine.DecodeEngine(jm, attn_kernel="einsum", **cfg))
    assert got == ref
    together = DecodeEngine(tm, device="cpu", **cfg)
    assert _serve(together, prompts, n=8) == got
    assert torch.isfinite(together._kc).all()
    assert torch.isfinite(together._vc).all()


def test_paged_attention_folds_groups_per_regime(models, monkeypatch):
    """Each paged-attention call sees q at H heads over a pool at Hkv;
    calls run the regime ``_k3_regime(T, G)`` picks: prefill buckets
    (T >= 16) in the tile regime, decode (T = 1) in the split regime,
    verify (T = k + 1 = 5) in the tile regime from G = 4 (20 folded
    rows), split at G = 2 (10)."""
    _, tm = models
    seen = []
    real = pa.paged_attention_plain

    def spy(q, k_pool, *a, **kw):
        seen.append((q.shape[1], q.shape[2], k_pool.shape[1]))
        return real(q, k_pool, *a, **kw)

    monkeypatch.setattr(pa, "paged_attention_plain", spy)
    eng = DecodeEngine(tm, device="cpu", speculate_k=4, spec_adaptive=False,
                       **GEOMETRY)
    _serve(eng, _prompts())
    cfg = tm.config
    g = cfg.num_attention_heads // cfg.num_key_value_heads
    assert {(h, hkv) for _, h, hkv in seen} == {
        (cfg.num_attention_heads, cfg.num_key_value_heads)}
    regimes = {t: pa._k3_regime(t, g) for t, _, _ in seen}
    assert regimes[1] == "split" and regimes[16] == "tile"
    assert regimes[5] == ("tile" if g == 4 else "split")
    layers = cfg.num_hidden_layers
    assert len(seen) == layers * (eng.prefill_calls + eng.decode_steps)
