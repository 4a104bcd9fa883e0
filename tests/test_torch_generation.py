"""The generation API of the PyTorch port (``paddle_tpu_torch/text/
generation.py``, ``GPTForCausalLM.generate`` / ``LlamaForCausalLM.
generate``, ``inference.enable_decode_engine``) against ``paddle_tpu`` on
the CPU, on a tiny GPT and a tiny Llama (2 layers, hidden 64, 4 heads; 2
kv heads for Llama; vocabulary 97; 64 positions) carrying the reference's
weights (``torch_port_utils``):

* greedy streams equal the reference's on the pow2-bucket loop
  (``generate(use_engine=False)``), the KV-cached ``model.generate``, the
  fixed-shape ``generate_padded`` and ``beam_search``, with the
  reference's dtype on each route;
* sampled streams (top-k, nucleus, temperature, a fixed seed) equal the
  reference's on the loop and cached routes: both draw with
  ``np.random.default_rng(seed)`` over float64 probabilities;
* with an engine attached, ``generate`` / ``generate_padded`` route
  through it and give the reference loop's greedy stream (the engine
  samples on the device, so only greedy streams are compared);
  ``use_engine=False``, ``disable_decode_engine`` and a request the engine
  cannot hold take the loop; an engine attached from an
  ``inference.Config`` (``Config.enable_decode_engine``) gives the same
  streams;
* eos / pad filling and the early stop on every route; the length check
  raising past ``max_position_embeddings`` on the loops; the model's
  training flag restored and no output requiring grad.

Token streams are compared exactly.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.text import generation as RG
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.text import generation as TG

from torch_port_utils import (jax_tiny_gpt, jax_tiny_llama, numpy_state,
                              torch_tiny_gpt, torch_tiny_llama)

VOCAB = 97
POSITIONS = 64
NEW = 10
SAMPLING = dict(do_sample=True, top_k=20, top_p=0.9, temperature=0.8,
                seed=11)
GPT_KW = dict(vocab_size=VOCAB, hidden_size=64, num_attention_heads=4,
              max_position_embeddings=POSITIONS)
LLAMA_KW = dict(group=2, vocab_size=VOCAB, hidden_size=64,
                max_position_embeddings=POSITIONS)


@pytest.fixture(scope="module", params=["gpt", "llama"])
def models(request):
    """(family, reference model, port model on the CPU)."""
    if request.param == "gpt":
        with jax_tiny_gpt(**GPT_KW) as jm:
            yield "gpt", jm, torch_tiny_gpt(numpy_state(jm), **GPT_KW)
    else:
        # the reference's dense attention: its flash route on the CPU is the
        # Pallas kernel in interpret mode, seconds a shape; the port keeps
        # its flash route (the kernels' plain versions on the CPU)
        with jax_tiny_llama(use_flash_attention=False, **LLAMA_KW) as jm:
            tm = torch_tiny_llama(numpy_state(jm), **LLAMA_KW)
            assert tm.config.num_key_value_heads == 2
            assert tm.config.use_flash_attention
            yield "llama", jm, tm


@pytest.fixture
def engine(models):
    """A ``DecodeEngine`` on the port model, detached after the test."""
    _, _, tm = models
    eng = tinf.enable_decode_engine(tm, device="cpu", num_slots=3,
                                    max_length=POSITIONS, page_size=4)
    yield eng
    tinf.disable_decode_engine(tm)


def _prompts(b=3, t=7, seed=0):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, t))


ROUTES = {
    "loop": lambda g, m, ids, **kw: g.generate(m, ids, NEW, use_engine=False,
                                               **kw),
    "cached": lambda g, m, ids, **kw: m.generate(ids, NEW, **kw),
    "padded": lambda g, m, ids, **kw: g.generate_padded(
        m, ids, ids.shape[1] + NEW, use_engine=False, **kw),
    "beam": lambda g, m, ids, **kw: g.beam_search(m, ids, 6, num_beams=3,
                                                  **kw),
}


def _both(route, models, ids, **kw):
    _, jm, tm = models
    want = ROUTES[route](RG, jm, ids, **kw)
    got = ROUTES[route](TG, tm, ids, **kw)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype, (route, got.dtype, want.dtype)
    return got, want


@pytest.mark.parametrize("route", list(ROUTES))
def test_greedy_streams_equal_reference(models, route):
    """Prompts of 7 tokens: the loop crosses its 16-token bucket (16, then
    a 17-token feed in a bucket capped at the total). Two prompts for the
    beams (the reference runs one shape per step and beam)."""
    ids = _prompts(b=2 if route == "beam" else 3)
    got, want = _both(route, models, ids)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] > ids.shape[1]
    np.testing.assert_array_equal(got[:, :ids.shape[1]], ids)


@pytest.mark.parametrize("route", ["loop", "cached"])
def test_sampled_streams_equal_reference(models, route):
    got, want = _both(route, models, _prompts(seed=1), **SAMPLING)
    np.testing.assert_array_equal(got, want)
    # the stream is a sample: another seed draws another one
    other = ROUTES[route](TG, models[2], _prompts(seed=1),
                          **dict(SAMPLING, seed=12))
    assert not np.array_equal(other, got)


def test_cached_and_loop_routes_agree(models):
    """The two routes of the port itself, greedy and sampled; for Llama
    also with the cached prefill on its dense route (``use_flash`` off:
    k / v repeated to every query head)."""
    fam, _, tm = models
    ids = _prompts(seed=2)
    for kw in ({}, SAMPLING):
        cached = ROUTES["cached"](TG, tm, ids, **kw)
        np.testing.assert_array_equal(cached,
                                      ROUTES["loop"](TG, tm, ids, **kw))
        if fam == "llama":
            attns = [blk.self_attn for blk in tm.llama.layers]
            try:
                for a in attns:
                    a.use_flash = False
                dense = ROUTES["cached"](TG, tm, ids, **kw)
            finally:
                for a in attns:
                    a.use_flash = True
            np.testing.assert_array_equal(dense, cached)


def test_engine_route_gives_the_reference_loop_stream(models, engine):
    """``generate`` and ``generate_padded`` go through the attached
    engine (its decode steps move; int32 ids, as the reference's engine
    route returns them) and give the reference loop's greedy tokens; one
    request of 57 + 7 tokens fills all 64 positions."""
    _, jm, tm = models
    for ids in (_prompts(seed=3), _prompts(b=1, t=POSITIONS - 7, seed=4)):
        n = min(NEW, POSITIONS - ids.shape[1])
        steps = engine.decode_steps
        got = TG.generate(tm, ids, n)
        assert engine.decode_steps > steps
        assert got.dtype == np.int32
        want = RG.generate(jm, ids, n, use_engine=False)
        np.testing.assert_array_equal(got, want)
        steps = engine.decode_steps
        got = TG.generate_padded(tm, ids, ids.shape[1] + n)
        assert engine.decode_steps > steps and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_engine_routing_falls_back_to_the_loop(models, engine):
    """``use_engine=False``, a prompt past the largest bucket, a total
    past the engine's cache and a detached engine take the loop (the
    input's dtype comes back); ``use_engine=None`` takes the engine."""
    _, jm, tm = models
    assert TG._engine_for(tm, None, 7, 17) is engine
    assert TG._engine_for(tm, True, 7, 17) is engine
    assert TG._engine_for(tm, False, 7, 17) is None
    assert TG._engine_for(tm, None, engine.buckets[-1] + 1,
                          engine.buckets[-1] + 2) is None
    assert TG._engine_for(tm, None, 7, POSITIONS + 1) is None
    ids = _prompts(seed=5)
    steps = engine.decode_steps
    got = TG.generate(tm, ids, NEW, use_engine=False)
    assert engine.decode_steps == steps and got.dtype == ids.dtype
    np.testing.assert_array_equal(
        got, RG.generate(jm, ids, NEW, use_engine=False))
    tinf.disable_decode_engine(tm)
    assert tm._decode_engine is None
    assert TG._engine_for(tm, None, 7, 17) is None
    assert TG.generate(tm, ids, NEW).dtype == ids.dtype
    # attached from an inference.Config: its engine settings on its device
    config = tinf.Config()
    config.disable_gpu()
    config.enable_decode_engine(num_slots=3, max_length=POSITIONS,
                                page_size=4)
    eng = tinf.enable_decode_engine(tm, config)
    try:
        assert tm._decode_engine is eng and eng.device.type == "cpu"
        assert (eng.config.num_slots, eng.config.page_size) == (3, 4)
        assert TG._engine_for(tm, None, 7, 17) is eng
        np.testing.assert_array_equal(
            TG.generate(tm, ids, NEW),
            RG.generate(jm, ids, NEW, use_engine=False))
    finally:
        tinf.disable_decode_engine(tm)


@pytest.fixture(scope="module")
def eos_case(models):
    """Two prompts, an eos id that row 0 emits after its first new token
    and row 1 not among its first two (its stream runs on), and the step
    at which row 0 first emits it."""
    _, jm, _ = models
    ids = _prompts(b=2, seed=6)
    free = RG.generate(jm, ids, NEW, use_engine=False)[:, ids.shape[1]:]
    eos = next(int(c) for c in free[0, 1:]
               if c != free[0, 0] and c not in free[1, :2])
    return ids, eos, int(np.flatnonzero(free[0] == eos)[0])


@pytest.mark.parametrize("route", list(ROUTES) + ["engine"])
def test_eos_fills_and_stops_as_reference(models, eos_case, route, request):
    ids, eos, k = eos_case
    if route == "engine":
        _, jm, tm = models
        request.getfixturevalue("engine")
        got = TG.generate(tm, ids, NEW, eos_token_id=eos, pad_token_id=0)
        want = RG.generate(jm, ids, NEW, use_engine=False,
                           eos_token_id=eos, pad_token_id=0)
    else:
        kw = dict(eos_token_id=eos)
        if route != "beam":
            kw["pad_token_id"] = 0
        got, want = _both(route, models, ids, **kw)
    np.testing.assert_array_equal(got, want)
    if route != "beam":
        t0 = ids.shape[1]
        assert got[0, t0 + k] == eos and (got[0, t0 + k + 1:] == 0).all()


def test_single_row_stops_early_at_eos(models, eos_case):
    ids, eos, k = eos_case
    for route in ("loop", "cached", "padded"):
        got, want = _both(route, models, ids[:1], eos_token_id=eos)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (1, ids.shape[1] + k + 1)


@pytest.mark.parametrize("route", list(ROUTES))
def test_length_check_raises_as_reference(models, route):
    """A prompt of 60 with 10 new tokens needs 70 > 64 positions: both
    packages raise on the loops (only the engine clamps positions)."""
    ids = _prompts(b=1, t=POSITIONS - 4, seed=7)
    _, jm, tm = models
    for g, m in ((RG, jm), (TG, tm)):
        with pytest.raises(ValueError, match="max_position_embeddings"):
            ROUTES[route](g, m, ids)


def test_training_flag_restored_and_nothing_requires_grad(models, engine):
    """Every route leaves the model in the mode it found it in; the
    forwards it ran produced no tensor that requires grad."""
    fam, _, tm = models
    seen = []
    norm = tm.gpt.final_layernorm if fam == "gpt" else tm.llama.norm
    hook = norm.register_forward_hook(
        lambda mod, inp, out: seen.append(out.requires_grad))
    try:
        ids = _prompts(b=2, seed=8)
        for training in (True, False):
            tm.train(training)
            for route in ROUTES:
                ROUTES[route](TG, tm, ids)
                assert tm.training is training, route
            TG.generate(tm, ids, NEW)  # the engine route
            assert tm.training is training
    finally:
        hook.remove()
        tm.eval()
    assert seen and not any(seen)
    assert torch.is_grad_enabled()
    assert all(p.grad is None for p in tm.parameters())
