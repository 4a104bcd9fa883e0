"""Serving engine of the PyTorch port against the reference engine.

The reference ``DecodeEngine`` (einsum attention oracle) and the port's
``DecodeEngine(device="cpu")`` serve the same requests on bridged weights;
greedy token streams must be equal — with and without speculation and
prefix sharing, for f32 and int8 KV pools.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import grad_comm as ref_grad_comm
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.text import generation as ref_generation
from paddle_tpu_torch.distributed import grad_comm
from paddle_tpu_torch.inference import engine as tengine
from paddle_tpu_torch.inference.engine import (DecodeEngine, EngineConfig,
                                               PagePool, SamplingParams)
from paddle_tpu_torch.text.generation import prompt_lookup_draft

from torch_port_utils import (VOCAB, jax_tiny_gpt, numpy_state,
                              torch_tiny_gpt)

GEOMETRY = dict(num_slots=3, max_length=64, page_size=4)
NEW_TOKENS = 12


def _prompts():
    """4 mixed-length requests; the first two share two full pages."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, VOCAB, 8)
    return [np.concatenate([shared, rng.integers(1, VOCAB, 3)]),
            np.concatenate([shared, rng.integers(1, VOCAB, 6)]),
            rng.integers(1, VOCAB, 5),
            np.concatenate([rng.integers(1, VOCAB, 4)] * 3)]


def _serve(engine, prompts, **params):
    rids = [engine.submit(p, max_new_tokens=NEW_TOKENS, **params)
            for p in prompts]
    engine.run()
    return [np.asarray(engine.result(r)).tolist() for r in rids]


@pytest.fixture(scope="module")
def models():
    with jax_tiny_gpt() as jm:
        yield jm, torch_tiny_gpt(numpy_state(jm))


CASES = [("f32", 0), ("f32", 2), ("int8", 2)]


@pytest.mark.parametrize("kv, k", CASES)
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
    assert eng.prefix_hit_tokens == ref_eng.prefix_hit_tokens == 8
    assert eng.verify_steps == ref_eng.verify_steps
    assert (k == 0) == (eng.verify_steps == 0)
    pool = eng.pool
    assert pool.available() + pool.referenced() == pool.num_pages - 1
    eng.release_prefix_cache()
    assert pool.available() == pool.num_pages - 1


def test_sampled_stream_independent_of_speculation(models):
    _, tm = models
    outs = []
    for k in (0, 3):
        eng = DecodeEngine(tm, device="cpu", speculate_k=k,
                           spec_adaptive=False, **GEOMETRY)
        outs.append(_serve(eng, _prompts(), do_sample=True, top_k=20,
                           top_p=0.9, temperature=0.8, seed=5))
    assert outs[0] == outs[1]
    # a sampled stream is not the greedy one
    greedy = _serve(DecodeEngine(tm, device="cpu", **GEOMETRY), _prompts())
    assert outs[0] != greedy


def test_warmup_is_state_neutral(models):
    _, tm = models
    cold = DecodeEngine(tm, device="cpu", speculate_k=2, **GEOMETRY)
    warm = DecodeEngine(tm, device="cpu", speculate_k=2, **GEOMETRY)
    info = warm.warmup()
    assert info == {"buckets": len(warm.buckets), "decode": True,
                    "verify": True}
    assert warm.pool.available() == warm.pool.num_pages - 1
    assert _serve(warm, _prompts()) == _serve(cold, _prompts())


def test_generate_batch_pads_and_matches_submit(models):
    _, tm = models
    ids = np.random.default_rng(2).integers(1, VOCAB, (2, 6))
    out = DecodeEngine(tm, device="cpu", **GEOMETRY).generate_batch(
        ids, max_new_tokens=5)
    eng = DecodeEngine(tm, device="cpu", **GEOMETRY)
    assert out.tolist() == _serve_n(eng, ids, 5)


def _serve_n(engine, rows, n):
    rids = [engine.submit(r, max_new_tokens=n) for r in rows]
    engine.run()
    return [engine.result(r).tolist() for r in rids]


def test_admission_waits_for_pages(models):
    """An overcommitted pool admits the next request once pages free."""
    _, tm = models
    eng = DecodeEngine(tm, device="cpu", num_pages=9, prefix_cache=False,
                       **GEOMETRY)
    got = _serve_n(eng, _prompts(), 8)
    ref = _serve_n(DecodeEngine(tm, device="cpu", prefix_cache=False,
                                **GEOMETRY), _prompts(), 8)
    assert got == ref and eng.peak_running < 3


def test_config_buckets_match_reference():
    for kw in ({}, dict(max_length=100), dict(prompt_buckets=(8, 40)),
               dict(max_length=64, page_size=5)):
        ref = ref_engine.EngineConfig(**kw)
        got = EngineConfig(**kw)
        assert got.resolved_buckets() == ref.resolved_buckets()
        assert got.max_pages == ref.max_pages
        assert got.resolved_num_pages() == ref.resolved_num_pages()
    assert [tengine.pow2_bucket(n) for n in (1, 16, 17, 100)] == [
        ref_engine.pow2_bucket(n) for n in (1, 16, 17, 100)]


def test_prefix_block_keys_match_reference():
    prompt = np.random.default_rng(4).integers(0, 50304, 37).astype(np.int32)
    for p in (4, 16):
        assert (tengine.PrefixRegistry.block_keys(prompt, p)
                == ref_engine.PrefixRegistry.block_keys(prompt, p))


def test_page_pool_refcounts():
    pool = PagePool(5)
    a = pool.alloc(3)
    assert a == [1, 2, 3] and pool.alloc(2) is None
    pool.incref(a[0])
    assert pool.shared_pages() == 1
    for pg in a + [a[0]]:
        pool.decref(pg)
    assert pool.available() == 4 and pool.referenced() == 0
    with pytest.raises(ValueError):
        pool.decref(1)
    with pytest.raises(ValueError):
        pool.incref(0)


@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_absmax_matches_reference(axis):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    # absmax 127 gives scale 1: the halves below round to even
    x[2, 3, :5] = [127.0, 2.5, -3.5, 0.5, 1.5]
    x[1, 1] = 0.0  # an all-zero row takes the tiny scale floor
    rq, rs = ref_grad_comm.quantize_absmax(jnp.asarray(x), axis=axis)
    q, s = grad_comm.quantize_absmax(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        grad_comm.dequantize_absmax(q, s).numpy(),
        np.asarray(ref_grad_comm.dequantize_absmax(rq, rs)))


def test_prompt_lookup_draft_matches_reference():
    rng = np.random.default_rng(6)
    for _ in range(50):
        ctx = rng.integers(0, 5, rng.integers(1, 20))
        k = int(rng.integers(1, 5))
        want = ref_generation.prompt_lookup_draft(ctx, k)
        got = prompt_lookup_draft(ctx, k)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_sampling_params_fields():
    assert SamplingParams().fields() == (1.0, 0, 1.0, True)
    assert SamplingParams(do_sample=True, temperature=0.0).fields()[3]
