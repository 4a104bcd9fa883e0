"""The port's workload replay (``paddle_tpu_torch/serving/replay.py``)
against the reference's, case for case with ``tests/test_replay.py``.

The module's value is its determinism contract: same spec, same seed,
same stream, same ledger digest, on any host and in either package. So
the arrival streams must equal the reference's event for event (5000
events at three specs), and whole stub-tier replays (``steady``, and
``mixed`` with an abusive tenant under quotas, each through 1 and 3
leaves, 3000 requests) must give the reference's digest and summary
counts. The stub tier's store contracts, the ledger, the shard
partition and the shard entry point (``python -m
paddle_tpu_torch.serving.replay``) are pinned as the reference pins its
own.
"""
import itertools
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.serving import replay as ref_replay
from paddle_tpu_torch.inference.engine import SamplingParams
from paddle_tpu_torch.serving import Router
from paddle_tpu_torch.serving.protocol import (k_count, k_done, k_engine,
                                               k_occ, unpack)
from paddle_tpu_torch.serving.replay import (MemStore, ReplayLedger,
                                             StubWorker, VirtualClock,
                                             _Reservoir, arrivals, make_spec,
                                             run_leaf_shard, run_stub_replay)
from paddle_tpu_torch.serving.router import RouterRequest

ROOT = Path(__file__).resolve().parents[1]


def _take(spec, n, gen=arrivals):
    return list(itertools.islice(gen(spec), n))


# -- arrival streams ----------------------------------------------------------

@pytest.mark.parametrize("spec", [
    dict(profile="steady", seed=0, rate_rps=3000.0),
    dict(profile="mixed", seed=42, rate_rps=2000.0),
    dict(profile="mixed", seed=7, rate_rps=4000.0, abuse_rps=6000.0,
         tenants=16, tagged_share=0.75)], ids=["steady", "mixed", "abuse"])
def test_arrivals_equal_reference_event_for_event(spec):
    kw = dict(spec)
    profile = kw.pop("profile")
    got = _take(make_spec(profile, **kw), 5000)
    want = _take(ref_replay.make_spec(profile, **kw), 5000,
                 ref_replay.arrivals)
    assert make_spec(profile, **kw) == ref_replay.make_spec(profile, **kw)
    for a, b in zip(got, want):
        assert (a["t"], a["tenant"], a["slo"], a["max_new_tokens"]) == (
            b["t"], b["tenant"], b["slo"], b["max_new_tokens"])
        assert a["prompt"].dtype == b["prompt"].dtype
        np.testing.assert_array_equal(a["prompt"], b["prompt"])


def test_arrivals_deterministic_and_time_ordered():
    spec = make_spec("mixed", seed=42, rate_rps=2000.0)
    a, b = _take(spec, 3000), _take(spec, 3000)
    for ea, eb in zip(a, b):
        assert (ea["t"], ea["tenant"], ea["slo"], ea["max_new_tokens"]) == (
            eb["t"], eb["tenant"], eb["slo"], eb["max_new_tokens"])
        np.testing.assert_array_equal(ea["prompt"], eb["prompt"])
    ts = [e["t"] for e in a]
    assert ts == sorted(ts) and ts[0] >= 0.0


def test_arrivals_seed_changes_stream():
    a = _take(make_spec("mixed", seed=1, rate_rps=2000.0), 500)
    b = _take(make_spec("mixed", seed=2, rate_rps=2000.0), 500)
    assert any(ea["t"] != eb["t"] for ea, eb in zip(a, b))


def test_arrivals_mix_properties():
    evs = _take(make_spec("mixed", seed=7, rate_rps=4000.0, tenants=16,
                          tagged_share=0.75), 8000)
    tagged = sum(1 for e in evs if e["tenant"] is not None)
    assert 0.65 < tagged / len(evs) < 0.85
    counts = Counter(e["tenant"] for e in evs if e["tenant"])
    assert counts.most_common(1)[0][0] == "t000"
    assert {e["slo"] for e in evs} == {"interactive", "standard", "batch"}
    assert max(len(e["prompt"]) for e in evs) >= 192


def test_agentic_sessions_grow_shared_prefixes():
    spec = {"seed": 3, "rate_rps": 200.0,
            "mix": [{"kind": "agentic", "share": 1.0, "turns": 5,
                     "think_s": 0.2, "turn_tokens": 8}],
            "tenants": {"n": 4, "tagged_share": 1.0},
            "slo_mix": {"interactive": 1.0},
            "prompt_tokens": [8, 16], "max_new_tokens": [4, 8]}
    evs = _take(spec, 400)
    by_len = sorted(evs, key=lambda e: len(e["prompt"]))
    extended = 0
    for i, e in enumerate(by_len):
        p = e["prompt"]
        if any(len(o["prompt"]) > len(p)
               and np.array_equal(o["prompt"][:len(p)], p)
               for o in by_len[i + 1:]):
            extended += 1
    assert extended >= len(evs) // 4
    ref = _take(spec, 400, ref_replay.arrivals)
    assert [e["prompt"].tolist() for e in evs] == [
        e["prompt"].tolist() for e in ref]


def test_abuse_component_respects_window():
    spec = make_spec("mixed", seed=9, rate_rps=1000.0, abuse_rps=2000.0)
    spec["abuse"]["start_s"] = 1.0
    spec["abuse"]["end_s"] = 2.0
    abuse_t = [e["t"] for e in _take(spec, 6000) if e["tenant"] == "abuser"]
    assert abuse_t and min(abuse_t) >= 1.0 and max(abuse_t) <= 2.1


# -- MemStore + StubWorker fidelity -------------------------------------------

def test_memstore_tcpstore_surface():
    s = MemStore()
    assert s.add("k", 1) == 1 and s.add("k", 2) == 3
    s.set("x", b"v")
    assert s.get("x") == b"v"
    assert s.check("x") and s.check(["x", "k"])
    assert not s.check(["x", "missing"])
    s.wait(["x"])
    with pytest.raises(RuntimeError):
        s.wait(["missing"])
    assert s.delete_key("x") and not s.delete_key("x")
    assert len(s) == 1


def test_stub_worker_registers_like_engine_worker():
    """The stub speaks the store registration and occupancy contract of
    the port's ``EngineWorker``: the keys its registration record and
    beat carry are the real worker's."""
    from paddle_tpu_torch.inference import engine as engine_mod
    from paddle_tpu_torch.serving import worker as worker_mod

    store, clock = MemStore(), VirtualClock()
    w = StubWorker(store, "ns", clock=clock, name="s0", num_slots=8)
    assert int(store.add(k_count("ns"), 0)) == 1
    rec = unpack(store.get(k_engine("ns", 0)))
    for key in ("name", "index", "num_slots", "max_length", "page_size",
                "buckets", "pid", "addr", "role", "kv_wire"):
        assert key in rec, key
    assert rec["name"] == "s0" and rec["role"] == "unified"
    w.poll()
    occ = unpack(store.get(k_occ("ns", "s0")))
    for key in ("beat", "acked_seq", "done_count", "name", "role",
                "prefill_queue", "draining", "drained",
                "outstanding_tokens"):
        assert key in occ, key
    src = (Path(worker_mod.__file__).read_text()
           + Path(engine_mod.__file__).read_text())
    for key in list(rec) + list(occ):
        assert f'"{key}"' in src, key
    w.poll()
    assert unpack(store.get(k_occ("ns", "s0")))["beat"] == occ["beat"] + 1


def test_stub_worker_serves_at_token_rate_and_writes_done():
    store, clock = MemStore(), VirtualClock()
    leaf = Router(store, namespace="ns", dataplane="store", clock=clock)
    w = StubWorker(store, "ns", clock=clock, name="s0", tokens_per_s=100.0)
    rid = leaf.submit(np.arange(40, dtype=np.int64), max_new_tokens=10)
    leaf.pump()
    w.poll()
    assert not store.check(k_done("ns", rid))  # no budget accrued yet
    clock.advance(0.3)   # 30 tokens: still short of cost 50
    w.poll()
    assert not store.check(k_done("ns", rid))
    clock.advance(0.25)  # 55: done, written before the acking beat
    w.poll()
    assert store.check(k_done("ns", rid))
    leaf.pump()
    assert leaf.status(rid) == "done" and len(leaf.result(rid)) > 0


def test_stub_results_derive_from_sampling_seed():
    store, clock = MemStore(), VirtualClock()
    leaf = Router(store, namespace="ns", dataplane="store", clock=clock,
                  retain_results=True)
    w = StubWorker(store, "ns", clock=clock, tokens_per_s=1e9)
    r1, r2, r3 = (leaf.submit(np.arange(8, dtype=np.int64), max_new_tokens=4,
                              seed=s) for s in (123, 123, 124))
    leaf.pump()
    clock.advance(1.0)
    w.poll()
    leaf.pump()
    np.testing.assert_array_equal(leaf.result(r1), leaf.result(r2))
    assert not np.array_equal(leaf.result(r1), leaf.result(r3))
    assert leaf.result(r1).tolist() == ref_replay.StubWorker._result_tokens(
        {"seed": 123, "max_new_tokens": 4})


# -- ledger -------------------------------------------------------------------

def test_reservoir_is_deterministic_and_bounded():
    r1, r2, ref = _Reservoir(cap=64), _Reservoir(cap=64), \
        ref_replay._Reservoir(cap=64)
    for i in range(10_000):
        v = float((i * 7919) % 1000)
        for r in (r1, r2, ref):
            r.add(v)
    assert r1.vals == r2.vals == ref.vals and len(r1.vals) <= 64
    assert 0.0 <= r1.quantile(0.5) <= 1000.0
    assert r1.quantile(0.0) <= r1.quantile(0.99)


def _req(status, tokens=None, reason=None):
    r = RouterRequest(rid=0, prompt=np.empty(0, np.int64),
                      params=SamplingParams(), slo="standard", submit_t=0.0,
                      deadline_t=1.0, block_keys=[], status=status,
                      shed_reason=reason)
    r.tenant = "t"
    if tokens is not None:
        r.tokens = np.asarray(tokens, dtype=np.int64)
    return r


def test_ledger_digest_covers_order_outcome_and_tokens():
    a, b, c, d = (ReplayLedger() for _ in range(4))
    ref = ref_replay.ReplayLedger()
    for led in (a, b, ref):
        led.resolve(1, _req("done", [1, 2]))
        led.resolve(2, _req("shed", reason="quota"))
    assert a.digest == b.digest == ref.digest
    c.resolve(2, _req("shed", reason="quota"))   # order flipped
    c.resolve(1, _req("done", [1, 2]))
    assert c.digest != a.digest
    d.resolve(1, _req("done", [1, 3]))           # different tokens
    d.resolve(2, _req("shed", reason="quota"))
    assert d.digest != a.digest
    assert a.rows[("t", "standard")]["shed_quota"] == 1


# -- end-to-end stub replay ---------------------------------------------------

#: what the reference's and the port's replays must agree on
_SAME = ("requests", "resolved", "digest", "classes", "tenants",
         "dispatched", "virtual_s", "ticks", "frontier")


@pytest.mark.parametrize("n_leaves", [1, 3])
@pytest.mark.parametrize("profile", ["steady", "mixed_abuse"])
def test_stub_replay_equals_reference(profile, n_leaves):
    """The whole tier replayed: the digest and every summary count equal
    the reference's (quotas of 20,000 tokens/s, burst 4000, under
    ``mixed`` with an abusive tenant)."""
    kw = dict(n_leaves=n_leaves, engines_per_leaf=2)
    if profile == "steady":
        args = ("steady",), dict(seed=0)
    else:
        args = ("mixed",), dict(seed=0, abuse_rps=8000.0)
        kw.update(quota_rate_tokens_per_s=20_000.0,
                  quota_burst_tokens=4000.0)
    got = run_stub_replay(make_spec(*args[0], **args[1]), 3000, **kw)
    want = ref_replay.run_stub_replay(
        ref_replay.make_spec(*args[0], **args[1]), 3000, **kw)
    assert got["resolved"] == got["requests"] == 3000
    if profile != "steady":
        assert got["frontier"]["quota_shed"] > 0
    assert {k: got[k] for k in _SAME} == {k: want[k] for k in _SAME}


def test_replay_resolves_everything_and_reaps_store():
    from paddle_tpu_torch.serving.replay import build_stub_tier, replay

    clock = VirtualClock()
    frontier, workers, stores = build_stub_tier(2, 2, clock,
                                                tokens_per_s=200_000.0)
    out = replay(frontier, workers, clock,
                 make_spec("mixed", seed=21, rate_rps=3000.0), 3000)
    assert out["resolved"] == out["requests"] == 3000
    total = sum(v for cls in out["classes"].values()
                for v in cls.values() if isinstance(v, int))
    assert total == 3000
    assert out["dispatch_rps"] > 0
    assert "admission_s" in out["classes"]["interactive"]
    # reaped: no more than the last unreaped batch of done keys stays
    assert sum(len(s) for s in stores) < 4096 + 64


def test_replay_heap_and_scan_dispatch_agree():
    """The heap dispatch places every request on the engine the scan
    would, so the run digests match."""
    spec = make_spec("mixed", seed=31, rate_rps=3000.0)
    kw = dict(n_leaves=1, engines_per_leaf=5, tokens_per_s=150_000.0)
    heap = run_stub_replay(spec, 2500, dispatch_mode="heap", **kw)
    scan = run_stub_replay(spec, 2500, dispatch_mode="scan", **kw)
    assert heap["digest"] == scan["digest"]
    assert heap["classes"] == scan["classes"]


def test_shard_partition_covers_stream_exactly():
    """Two leaf shards partition the global stream (every gid in exactly
    one), each shard is deterministic, and each equals the reference's
    shard."""
    spec = make_spec("mixed", seed=17, rate_rps=3000.0)
    kw = dict(engines_per_leaf=2, tokens_per_s=500_000.0)
    whole = run_leaf_shard(spec, 2000, ["leaf0"], "leaf0", **kw)
    a = run_leaf_shard(spec, 2000, ["leaf0", "leaf1"], "leaf0", **kw)
    b = run_leaf_shard(spec, 2000, ["leaf0", "leaf1"], "leaf1", **kw)
    assert whole["requests"] == a["requests"] + b["requests"] == 2000
    assert 0 < a["requests"] < 2000
    assert a["done"] + a["shed"] + b["done"] + b["shed"] == 2000
    a2 = run_leaf_shard(spec, 2000, ["leaf0", "leaf1"], "leaf0", **kw)
    assert a2["digest"] == a["digest"]
    ref = ref_replay.run_leaf_shard(spec, 2000, ["leaf0", "leaf1"], "leaf0",
                                    **kw)
    drop = ("wall_s", "gen_s")
    assert {k: v for k, v in a.items() if k not in drop} == {
        k: v for k, v in ref.items() if k not in drop}


def test_shard_entry_point_prints_the_shard():
    """``python -m paddle_tpu_torch.serving.replay`` prints the shard's
    metrics as the only line of its stdout, equal to the in-process
    shard's."""
    args = ["--shard", "leaf1", "--leaves", "leaf0,leaf1", "--requests",
            "600", "--seed", "4", "--rate-rps", "2000", "--engines", "2"]
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.replay", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    want = run_leaf_shard(make_spec("mixed", seed=4, rate_rps=2000.0), 600,
                          ["leaf0", "leaf1"], "leaf1", engines_per_leaf=2)
    drop = ("wall_s", "gen_s")
    assert {k: v for k, v in got.items() if k not in drop} == {
        k: v for k, v in want.items() if k not in drop}


def test_virtual_clock_controls_deadlines():
    """A queued request past its class deadline sheds when the virtual
    clock says so, not by wall time."""
    store, clock = MemStore(), VirtualClock()
    leaf = Router(store, namespace="ns", dataplane="store", clock=clock,
                  deadlines={"interactive": 1.0})
    rid = leaf.submit(np.arange(8, dtype=np.int64), slo="interactive",
                      max_new_tokens=4)
    leaf.pump()
    assert leaf.status(rid) == "queued"
    clock.advance(1.5)
    leaf.pump()
    assert leaf.status(rid) == "shed"
    assert leaf._requests[rid].shed_reason == "deadline"
