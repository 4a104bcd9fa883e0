"""The decode engine at mp > 1 (``inference/engine.py`` with
``EngineConfig(mesh=...)``, ``text/models/_mp_decode.py``) against the
reference's ``tests/test_serving_mp_shard.py``.

One spawn of 2 gloo ranks serves the reference test's workload (three
prompts sharing two full pages, the middle one sampled; prefix sharing
and speculation on) at mp 2: each model whole through a ``ProcessMesh``
with an ``mp`` axis, and built at mp 2 through the mp layers (a vocab 2
divides). Meanwhile this process runs the reference's single-device
engine and its ``generate`` on the same weights (bridged through numpy).
Greedy streams must equal the reference's exactly; the sampled stream
(torch's generator, not threefry) must equal the port's own mp-1 engine
and be the same on both ranks. The logit-wire resolution table is held
against the reference's case for case, on a mesh whose mp group holds
rank lists only (the engine's construction sends nothing)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.distributed import mp_comm
from paddle_tpu_torch.distributed.env import Group
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig

from torch_port_utils import (ENGINE_MP_CFG, engine_drain, engine_mp_job,
                              engine_mp_workload, jax_tiny_gpt,
                              jax_tiny_llama, join_ranks, numpy_state,
                              spawn_ranks, torch_tiny_gpt, torch_tiny_llama)

GEN_NEW = 8
CASES = [
    # vocab 61: the whole model only (its last vocab block is padded), the
    # exact f32 wire, generate through the engine route
    dict(name="gpt61", kind="gpt", model="gpt61", vocab=61, generate=True),
    dict(name="gpt64_int8_wire", kind="gpt", model="gpt64", vocab=64,
         wire="int8", model_kw=dict(vocab_size=64)),
    dict(name="llama_g4_int8_kv", kind="llama", model="llama_g4", vocab=64,
         kv="int8", model_kw=dict(group=4, vocab_size=64), generate=True),
]
MODELS = {"gpt61": ("gpt", {}), "gpt64": ("gpt", dict(vocab_size=64)),
          "llama_g2": ("llama", {}),
          "llama_g4": ("llama", dict(group=4, vocab_size=64))}
#: the models the spawned ranks serve (the Llama at G = 2 is only built
#: here, for the divide check)
SERVED = ("gpt61", "gpt64", "llama_g4")


def _ids(vocab):
    return np.random.default_rng(3).integers(1, vocab, (2, 12)).astype(
        np.int32)


def _ref_engine(model, reqs, ids=None, **kw):
    """The reference's single-device engine on ``reqs`` (greedy rows are
    the comparison: its sampled rows draw from threefry), then, given
    ``ids``, its batch front end ``generate_batch`` (the route of the
    reference's ``generate`` with an engine attached, greedy: the tokens
    of its loop)."""
    from paddle_tpu.inference.engine import (DecodeEngine as RE,
                                             EngineConfig as RC,
                                             SamplingParams as RS)

    eng = RE(model, RC(**ENGINE_MP_CFG, **kw))
    rids = [eng.submit(p, RS(**k)) for p, k in reqs]
    eng.run()
    out = {"streams": [np.asarray(eng.result(r)) for r in rids]}
    if ids is not None:
        out["generate"] = np.asarray(eng.generate_batch(
            ids, max_new_tokens=GEN_NEW))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states, refs = {}, {}
    for name, (kind, kw) in MODELS.items():
        make = jax_tiny_gpt if kind == "gpt" else jax_tiny_llama
        with make(**kw) as m:
            states[name] = numpy_state(m)
    ids = {v: _ids(v) for v in (61, 64)}
    out = tmp_path_factory.mktemp("engine_mp")
    ctx = spawn_ranks(engine_mp_job, 2, out, CASES,
                      {k: states[k] for k in SERVED}, ids)
    for case in CASES:
        kind, kw = MODELS[case["model"]]
        make = jax_tiny_gpt if kind == "gpt" else jax_tiny_llama
        with make(**kw) as m:
            refs[case["name"]] = _ref_engine(
                m, engine_mp_workload(case["vocab"]),
                ids[case["vocab"]] if case.get("generate") else None,
                kv_dtype=case.get("kv", "f32"))
    ranks = join_ranks(ctx, out)
    return dict(ranks=ranks, refs=refs, states=states, ids=ids)


def _port_mp1(case, state):
    m = (torch_tiny_gpt if case["kind"] == "gpt" else torch_tiny_llama)(
        state, **case.get("model_kw", {}))
    eng = DecodeEngine(m, EngineConfig(**ENGINE_MP_CFG,
                                       kv_dtype=case.get("kv", "f32")),
                       device="cpu")
    return engine_drain(eng, engine_mp_workload(case["vocab"]))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_mp2_streams_equal_the_reference(runs, case):
    reqs = engine_mp_workload(case["vocab"])
    want = runs["refs"][case["name"]]["streams"]
    mine = _port_mp1(case, runs["states"][case["model"]])
    for rank in runs["ranks"]:
        res = rank[case["name"]]
        for kind in ("mesh", "split"):
            if kind not in res:
                continue
            got = res[kind]["streams"]
            for (_, kw), w, g, m1 in zip(reqs, want, got, mine):
                if not kw["do_sample"]:  # greedy: the reference's tokens
                    np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, m1)
    a, b = (r[case["name"]] for r in runs["ranks"])
    for kind in a:
        if isinstance(a[kind], dict):  # the two ranks emit the same tokens
            for x, y in zip(a[kind]["streams"], b[kind]["streams"]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_pool_holds_the_rank_heads_and_prefix_sharing_survives(runs, case):
    kind, kw = MODELS[case["model"]]
    hkv = 4 if kind == "gpt" else {2: 2, 4: 2}[kw.get("group", 2)]
    for rank in runs["ranks"]:
        for res in (v for v in rank[case["name"]].values()
                    if isinstance(v, dict)):
            assert res["pool"][2] == hkv // 2
            if case.get("kv") == "int8":
                assert res["scales"] == res["pool"][:4]
            # two full pages of shared prefix, reused by two requests
            assert res["prefix_hit_tokens"] >= 32
            assert res["verify_steps"] > 0


def _wire_bytes_want(res, vocab, wire, k=ENGINE_MP_CFG["speculate_k"],
                     slots=ENGINE_MP_CFG["num_slots"]):
    """The reference's price (``logit_wire_bytes``) of every program run:
    a prefill's one row, a decode step's ``S`` rows, a verify step's
    ``S (k + 1)``."""
    f = lambda rows: mp_comm.logit_wire_bytes(rows, vocab, 2, wire)[1]  # noqa
    decode = res["steps"] - res["verify_steps"]
    return (res["prefills"] * f(1) + decode * f(slots)
            + res["verify_steps"] * f(slots * (k + 1)))


@pytest.mark.parametrize("name,wire", [("gpt64_int8_wire", "int8"),
                                       ("llama_g4_int8_kv", "f32")])
def test_logit_wire_bytes_match_the_price(runs, name, wire):
    for rank in runs["ranks"]:
        for res in (v for v in rank[name].values() if isinstance(v, dict)):
            assert res["wire"] == wire and res["verify"]
            assert res["wire_bytes"] == pytest.approx(
                _wire_bytes_want(res, 64, wire), rel=0, abs=1e-6)


@pytest.mark.parametrize("case", [c for c in CASES if c.get("generate")],
                         ids=[c["name"] for c in CASES if c.get("generate")])
def test_generate_at_mp2_equals_the_reference(runs, case):
    want = runs["refs"][case["name"]]["generate"]
    for rank in runs["ranks"]:
        res = rank[case["name"]]
        for route in ("generate_engine", "generate_split", "loop_split"):
            if route in res:
                np.testing.assert_array_equal(np.asarray(res[route]), want)


# -- construction: the divide check and the logit-wire resolution ----------

def _rank_list_mesh(mp):
    """A dp 1 x mp ``mp`` mesh whose groups hold rank lists only."""
    pm = ProcessMesh(np.arange(mp).reshape(1, mp), dim_names=["dp", "mp"])
    pm.set_groups([Group([0]), Group(list(range(mp)))])
    return pm


@pytest.fixture(scope="module")
def model64(runs):
    return torch_tiny_gpt(runs["states"]["gpt64"], vocab_size=64)


@pytest.mark.parametrize("mp", [8, 3])
def test_mp_must_divide_kv_heads(model64, mp):
    mesh = ProcessMesh(np.arange(mp).reshape(1, mp), dim_names=["dp", "mp"])
    with pytest.raises(ValueError, match="divide"):
        DecodeEngine(model64, EngineConfig(num_slots=2, max_length=64,
                                           mesh=mesh), device="cpu")


def test_llama_mp_must_divide_kv_heads(runs):
    m = torch_tiny_llama(runs["states"]["llama_g2"])  # 2 kv heads
    with pytest.raises(ValueError, match="divide"):
        DecodeEngine(m, EngineConfig(num_slots=2, max_length=64,
                                     mesh=_rank_list_mesh(4)), device="cpu")


WIRE_TABLE = [  # (logit_wire, mp, PADDLE_TPU_MP_COMM)
    ("off", 2, None), ("f32", 2, None), ("int8", 2, None), ("bf16", 2, None),
    ("int8", 1, None), (None, 2, None), (None, 2, "int8,verify=off"),
    (None, 2, "bf16"), (None, 1, "int8"), ("off", 2, "int8")]


@pytest.mark.parametrize("wire,mp,env", WIRE_TABLE)
def test_logit_wire_resolution_matches_the_reference(runs, model64,
                                                     monkeypatch, wire, mp,
                                                     env):
    import jax
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.inference.engine import (DecodeEngine as RE,
                                             EngineConfig as RC)

    from torch_port_utils import jax_tiny_gpt

    if env is None:
        monkeypatch.delenv("PADDLE_TPU_MP_COMM", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_MP_COMM", env)
    ref_mesh = (build_mesh((1, mp), ("dp", "mp"),
                           devices=jax.devices()[:mp]) if mp > 1 else None)
    with jax_tiny_gpt(vocab_size=64) as rm:
        ref = RE(rm, RC(**ENGINE_MP_CFG, mesh=ref_mesh, logit_wire=wire))
    eng = DecodeEngine(model64, EngineConfig(
        **ENGINE_MP_CFG, logit_wire=wire,
        mesh=_rank_list_mesh(mp) if mp > 1 else None), device="cpu")
    assert (eng._logit_wire, eng._logit_verify) == \
        (ref._logit_wire, ref._logit_verify)
    assert eng._mp_degree == ref._mp_degree == mp


def test_unknown_logit_wire_raises(model64):
    with pytest.raises(ValueError, match="logit_wire"):
        DecodeEngine(model64, EngineConfig(**ENGINE_MP_CFG,
                                           logit_wire="fp8"), device="cpu")


def test_whole_model_slices_are_views_of_the_rank_heads(runs):
    """The adapter's slices of a whole model at rank 1 of 2: the rank's
    heads' QKV columns (head-major), the matching ``out_proj`` rows, the
    rank's vocab rows of the tied head."""
    m = torch_tiny_gpt(runs["states"]["gpt64"], vocab_size=64)
    g = Group([1, 0])  # this process is rank 0 of the world: index 1 here
    ad = m.decode_adapter(mp_group=g)
    attn = m.gpt.decoder[0].attn
    wq, bq, wo, bo = ad._attn[0]
    d, hl = ad.head_dim, ad.num_heads // 2
    torch.testing.assert_close(wq, attn.qkv_proj.weight[:, 3 * d * hl:],
                               rtol=0, atol=0)
    torch.testing.assert_close(bq, attn.qkv_proj.bias[3 * d * hl:],
                               rtol=0, atol=0)
    torch.testing.assert_close(wo, attn.out_proj.weight[d * hl:],
                               rtol=0, atol=0)
    assert bo is attn.out_proj.bias
    h = torch.randn(3, 32, generator=torch.Generator().manual_seed(0))
    want = h @ m.gpt.embeddings.word_embeddings.weight[32:].t()
    torch.testing.assert_close(ad.logits(h), want, rtol=0, atol=0)
