"""The serving engine's worker surface in the port (``occupancy``,
``prefill_export``, ``try_import_prefill``) against the reference engine.

The tiny GPT is bridged from the reference's weights
(``torch_port_utils``); each KV dtype runs ONE reference ``DecodeEngine``
(einsum attention) through a scripted sequence — the bad requests, two
prefill exports (the second hitting the first's prefix blocks), four
submissions, one step, a drain — and the port's engine runs the same
script, telemetry on. Compared: the ValueError messages (equal), every
``occupancy()`` snapshot (equal), the tenant ledger's integer cells
(equal; the page-second integral, which integrates wall time, aside),
the exports' ``first_token`` / ``true_len`` / page count (equal) and pages (f32: within 1e-5 absolute, the two f32 prefills'
rounding; int8 pool: the quantized bytes within one level, where the
absmax lands at a rounding boundary, and the scale slabs within 1e-5
relative), and the greedy streams (equal). Then the port's exports,
through the ``raw`` wire's frame codec, are imported by a second port
engine, whose decode gives the reference's greedy streams; bf16 pages
travel as their 16-bit words and land bit-equal; a sampled request with a
router-style explicit seed decodes as the port's unified engine does.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import engine as ref_engine
from paddle_tpu_torch.framework.dtype import from_host
from paddle_tpu_torch.inference.engine import DecodeEngine, SamplingParams
from paddle_tpu_torch.serving.transport import (FrameDecoder, decode_kv,
                                                encode_frame, encode_kv)

from torch_port_utils import VOCAB, jax_tiny_gpt, numpy_state, torch_tiny_gpt

GEOMETRY = dict(num_slots=3, max_length=64, page_size=4)
NEW = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny CPU models: the suite runs
    6 test processes at once, and 6 pools of spinning threads slowed this
    file's tests up to 20-fold there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts():
    rng = np.random.default_rng(11)
    shared = rng.integers(1, VOCAB, 8)
    return [np.concatenate([shared, rng.integers(1, VOCAB, 3)]),
            np.concatenate([shared, rng.integers(1, VOCAB, 6)]),
            rng.integers(1, VOCAB, 5),
            rng.integers(1, VOCAB, 13)]


def _errors(eng, params_cls):
    """Messages of the bad-request ValueErrors, in a fixed order."""
    p = params_cls(max_new_tokens=NEW)
    calls = [
        lambda: eng.submit(np.zeros(0, np.int64), p),
        lambda: eng.submit(np.ones(65, np.int64), p),
        lambda: eng.submit(np.ones(60, np.int64), p),
        lambda: eng.prefill_export(np.zeros(0, np.int64), p),
        lambda: eng.prefill_export(np.ones(65, np.int64), p),
        lambda: eng.prefill_export(np.ones(60, np.int64), p),
        lambda: eng.try_import_prefill(np.ones(9, np.int64), p,
                                       {"true_len": 8}),
        lambda: eng.try_import_prefill(np.ones(60, np.int64), p,
                                       {"true_len": 60}),
    ]
    out = []
    for call in calls:
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    return out


TENANTS = ("acme", None, "beta", "acme")


def _script(eng, params_cls):
    prompts = _prompts()
    errs = _errors(eng, params_cls)
    exports = [eng.prefill_export(prompts[i], params_cls(max_new_tokens=NEW),
                                  tenant=TENANTS[i], slo="interactive")
               for i in (0, 1)]
    occ = [eng.occupancy()]
    rids = [eng.submit(p, params_cls(max_new_tokens=NEW), tenant=t)
            for p, t in zip(prompts, TENANTS)]
    occ.append(eng.occupancy())
    eng.step()
    occ.append(eng.occupancy())
    eng.run()
    occ.append(eng.occupancy())
    streams = [np.asarray(eng.result(r)).tolist() for r in rids]
    # the tenant ledger's integer fields (kv_page_us integrates wall time)
    ledger = {key: {f: v for f, v in cell.items()
                    if f not in ("kv_page_us", "queue_seconds")}
              for key, cell in eng.accounting_ledger().cells().items()}
    return dict(errors=errs, exports=exports, occupancy=occ,
                streams=streams, ledger=ledger)


@pytest.fixture(scope="module")
def models():
    with jax_tiny_gpt() as jm:
        yield jm, torch_tiny_gpt(numpy_state(jm))


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """The reference's and the port's scripted runs, per KV dtype, with
    telemetry (and so tenant accounting) on."""
    jm, tm = models
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TELEMETRY_DIR",
                  str(tmp_path_factory.mktemp("telemetry")))
        mp.delenv("PADDLE_TPU_LIVE_TELEMETRY", raising=False)
        for kv in ("f32", "int8"):
            ref = _script(ref_engine.DecodeEngine(
                jm, attn_kernel="einsum", kv_dtype=kv, **GEOMETRY),
                ref_engine.SamplingParams)
            got = _script(DecodeEngine(tm, device="cpu", kv_dtype=kv,
                                       **GEOMETRY), SamplingParams)
            out[kv] = (ref, got)
    return out


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_errors_occupancy_and_streams_equal_reference(runs, kv):
    ref, got = runs[kv]
    assert got["errors"] == ref["errors"]
    assert got["occupancy"] == ref["occupancy"]
    assert got["occupancy"][0]["prefix_hit_tokens"] == 8  # 2nd export's hit
    assert got["streams"] == ref["streams"]
    assert got["occupancy"][-1]["running"] == 0
    # every tenant cell's tokens, requests and export wire bytes
    assert got["ledger"] == ref["ledger"]
    assert got["ledger"][("acme", "interactive")]["wire_bytes"] > 0


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_prefill_export_matches_reference(runs, kv):
    ref, got = runs[kv]
    for r, g, p in zip(ref["exports"], got["exports"], _prompts()):
        assert g["first_token"] == r["first_token"]
        assert g["true_len"] == r["true_len"] == len(p)
        assert g["pool_dtype"] == r["pool_dtype"] == kv
        n_pages = -(-len(p) // GEOMETRY["page_size"])
        for key in ("k", "v"):
            want = np.asarray(r[key])
            assert g[key].shape == want.shape
            assert g[key].shape[1] == n_pages
            if kv == "f32":
                np.testing.assert_allclose(g[key], want, rtol=0, atol=1e-5)
            else:
                diff = np.abs(g[key].astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1
        if kv == "int8":
            for key in ("ks", "vs"):
                np.testing.assert_allclose(g[key], np.asarray(r[key]),
                                           rtol=1e-5, atol=0)
        else:
            assert "ks" not in g


def _wire(payload, wire="raw"):
    """A prefill_export payload through encode_kv, the frame codec and
    decode_kv, as the worker ships it."""
    kv = encode_kv(payload["k"], payload["v"], wire, payload.get("ks"),
                   payload.get("vs"), dtype=payload["dtype"])
    (frame,) = FrameDecoder().feed(encode_frame({"t": "kv", "kv": kv}))
    got = decode_kv(frame["kv"])
    out = {"first_token": payload["first_token"],
           "true_len": payload["true_len"],
           "prefill_s": payload["prefill_s"],
           "k": got["k"], "v": got["v"], "dtype": got["dtype"]}
    if "k_scale" in got:
        out["ks"], out["vs"] = got["k_scale"], got["v_scale"]
    return out


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_import_decodes_the_reference_unified_streams(models, runs, kv):
    _, tm = models
    ref, got = runs[kv]
    prompts = _prompts()
    src = DecodeEngine(tm, device="cpu", kv_dtype=kv, **GEOMETRY)
    dst = DecodeEngine(tm, device="cpu", kv_dtype=kv, **GEOMETRY)
    params = SamplingParams(max_new_tokens=NEW)
    rids = []
    for i in (0, 1):
        payload = src.prefill_export(prompts[i], params)
        rid = dst.try_import_prefill(prompts[i], params, _wire(payload))
        assert rid is not None
        # the imported content pages are the exported bytes
        req = dst._requests[rid]
        idx = torch.as_tensor(req.page_ids[:payload["k"].shape[1]])
        assert np.array_equal(dst._kc[:, idx].numpy(), payload["k"])
        if kv == "int8":
            assert np.array_equal(dst._ksc[:, idx].numpy(), payload["ks"])
        rids.append(rid)
    assert src.occupancy()["running"] == 0 and src.occupancy()["slots_free"] == 3
    dst.run()
    # the reference engine's greedy streams of the same prompts
    assert [dst.result(r).tolist() for r in rids] == ref["streams"][:2]
    assert dst.stats()["prefill_calls"] == 0  # no local prefill ran
    assert all(dst._requests[r].imported for r in rids)


def test_bf16_pages_travel_as_words_and_sampled_import_matches(models):
    _, tm = models
    prompts = _prompts()
    src = DecodeEngine(tm, device="cpu", kv_dtype="bf16", **GEOMETRY)
    dst = DecodeEngine(tm, device="cpu", kv_dtype="bf16", **GEOMETRY)
    uni = DecodeEngine(tm, device="cpu", kv_dtype="bf16", **GEOMETRY)
    params = [SamplingParams(max_new_tokens=NEW),
              SamplingParams(max_new_tokens=NEW, do_sample=True,
                             temperature=0.7, top_k=8, seed=5_000_011)]
    rids, want = [], []
    for p, sp in zip(prompts[2:], params):
        payload = src.prefill_export(p, sp)
        assert payload["dtype"] == "bfloat16"
        assert payload["k"].dtype == np.int16
        rid = dst.try_import_prefill(p, sp, _wire(payload))
        req = dst._requests[rid]
        idx = torch.as_tensor(req.page_ids[:payload["k"].shape[1]])
        assert torch.equal(dst._kc[:, idx],
                           from_host(payload["k"], "bfloat16"))
        rids.append(rid)
        want.append(uni.submit(p, sp))
    dst.run()
    uni.run()
    assert [dst.result(r).tolist() for r in rids] == \
        [uni.result(r).tolist() for r in want]


def test_export_waits_for_a_slot_and_finishes_one_token_budgets(models):
    _, tm = models
    eng = DecodeEngine(tm, device="cpu", num_slots=1, max_length=64,
                       page_size=4)
    p = _prompts()[2]
    rid = eng.submit(p, max_new_tokens=NEW)
    eng.step()  # the slot is taken
    assert eng.prefill_export(p, SamplingParams(max_new_tokens=NEW)) is None
    eng.run()
    done = eng.prefill_export(p, SamplingParams(max_new_tokens=1))
    assert done["done"].tolist() == eng.result(rid).tolist()[:len(p) + 1]
    assert eng.occupancy()["slots_free"] == 1
    pool = eng.pool
    eng.release_prefix_cache()
    assert pool.available() == pool.num_pages - 1
