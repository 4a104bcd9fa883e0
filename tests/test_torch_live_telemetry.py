"""The port's live telemetry plane (``paddle_tpu_torch/observability/
live.py``) and fleet aggregation (``observability/fleet.py``) held
against the reference's (``paddle_tpu/observability/live.py`` /
``fleet.py``), mirroring ``tests/test_live_telemetry.py`` and
``tests/test_telemetry_fleet.py``.

Both packages see the same inputs: samples and span records drawn from
seeded numpy generators, the same payloads, the same snapshots. The
mergeable histograms are pure float arithmetic in the same order, so
their buckets, counts and quantiles must be BIT-EQUAL; the aggregators'
health documents (windows, burn rates through ``compute_burn``, phase
attribution, dedup, stragglers, stage imbalance, queues) must be EQUAL
as JSON, with the tenant prices set alike (each package prices from its
own planner calibration by default). ``merge_snapshots`` documents equal
but for their ``ts``.

End to end on the CPU: a port ``Router`` and two ``EngineWorker`` s with
the plane on, each worker shipping ``tele`` frames on its beat; every
payload ingested exactly once and ``fleet_health.json``'s burn rates
equal to the reference's post-hoc ``tracing.summarize_dir`` over the
port's span files (p95 within 5 %, the reference test's bound).
"""
import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from conftest import free_port

from paddle_tpu.observability import fleet as ref_fleet
from paddle_tpu.observability import live as ref_live
from paddle_tpu.observability import tracing as ref_tracing
from paddle_tpu.serving.protocol import SLO_OBJECTIVES as REF_OBJECTIVES
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import fleet, live, tracing
from paddle_tpu_torch.serving.protocol import SLO_OBJECTIVES

from torch_port_utils import VOCAB, jax_tiny_gpt, numpy_state, torch_tiny_gpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spans(seed, n_roots=40):
    """Seeded span records: request roots over the SLO classes (done /
    shed / failed, latencies around each class's target), phases before
    and after their roots, and train steps of 5 ranks, rank 4 slow."""
    rng = np.random.default_rng(seed)
    ids = itertools.count(1)
    out = []
    classes = list(SLO_OBJECTIVES)
    for _ in range(n_roots):
        slo = classes[int(rng.integers(len(classes)))]
        target = SLO_OBJECTIVES[slo]["latency_target_s"]
        tid = f"t{seed}-{next(ids)}"
        status = ("shed", "failed", "done", "done", "done")[
            int(rng.integers(5))]
        phase_first = bool(rng.integers(2))
        phases = [{"kind": "span", "name": name, "trace_id": tid,
                   "span_id": f"s{seed}-{next(ids)}", "parent_id": "p",
                   "ts": 0.0, "dur_s": float(rng.uniform(0.01, 0.5)),
                   "rank": 0, "pid": 0}
                  for name in ("srv_queue", "srv_prefill", "srv_decode")]
        root = {"kind": "span", "name": "srv_request", "trace_id": tid,
                "span_id": f"s{seed}-{next(ids)}", "parent_id": None,
                "ts": 0.0,
                "dur_s": float(rng.uniform(0.2, 1.6) * target),
                "rank": 0, "pid": 0,
                "attrs": {"slo": slo, "status": status,
                          "tenant": f"ten{int(rng.integers(3))}"}}
        out += phases + [root] if phase_first else [root] + phases
    for r in range(5):
        for _ in range(4):
            out.append({"kind": "span", "name": "train_step",
                        "trace_id": f"tr{next(ids)}",
                        "span_id": f"s{seed}-{next(ids)}",
                        "parent_id": None, "ts": 0.0,
                        "dur_s": float((1.0 if r == 4 else 0.1)
                                       * rng.uniform(0.95, 1.05)),
                        "rank": r, "pid": 0})
    return out


def _aggs(**kw):
    """(port, reference) aggregators with equal tenant prices."""
    from paddle_tpu.observability import accounting as ref_acct

    from paddle_tpu_torch.observability import accounting

    kw.setdefault("tail_local", False)
    a, b = live.LiveAggregator(**kw), ref_live.LiveAggregator(**kw)
    a._tenant_prices = accounting.Prices()
    b._tenant_prices = ref_acct.Prices()
    return a, b


def _same_doc(a, b):
    assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))


# -- the mergeable histogram ---------------------------------------------

def test_histogram_bounds_buckets_and_quantiles_bit_equal():
    assert live.BOUNDS == ref_live.BOUNDS
    rng = np.random.default_rng(0)
    samples = np.concatenate([
        rng.lognormal(mean=-3.0, sigma=1.2, size=4000),
        rng.uniform(0.0, 5e-5, size=50),
        np.asarray(live.BOUNDS[1:60]),            # exact bucket edges
        np.asarray([live.BOUNDS[-1] * 1.01])]).tolist()  # the last bucket
    for v in samples:
        assert live._bucket_index(v) == ref_live._bucket_index(v)
    # past the ladder (~23 min): the port's last bucket absorbs it, the
    # reference indexes past BOUNDS (ROADMAP.md §C.36)
    assert live._bucket_index(1e9) == len(live.BOUNDS) - 1
    with pytest.raises(IndexError):
        ref_live._bucket_index(1e9)
    a, b = live.MergeableHistogram(), ref_live.MergeableHistogram()
    for v in samples:
        a.add(v)
        b.add(v)
    assert a.counts == b.counts and a.count == b.count
    assert (a.sum, a.min, a.max, a.mean) == (b.sum, b.min, b.max, b.mean)
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)
    # within one bucket of the exact nearest-rank order statistic
    srt = sorted(samples)
    for q in (0.5, 0.95, 0.99):
        exact = srt[int(round(q * (len(srt) - 1)))]
        i = live._bucket_index(exact)
        hi = live.BOUNDS[i + 1] if i + 1 < len(live.BOUNDS) else a.max
        assert abs(a.quantile(q) - exact) <= hi - live.BOUNDS[i] + 1e-12
    e, f = live.MergeableHistogram(), ref_live.MergeableHistogram()
    assert e.quantile(0.95) == f.quantile(0.95) == 0.0


def test_histogram_merge_bit_equal():
    rng = np.random.default_rng(1)
    va = rng.lognormal(-2.0, 1.0, 500).tolist()
    vb = rng.lognormal(-1.0, 0.5, 300).tolist()
    pa, pb, ra, rb = (live.MergeableHistogram(), live.MergeableHistogram(),
                      ref_live.MergeableHistogram(),
                      ref_live.MergeableHistogram())
    for v in va:
        pa.add(v)
        ra.add(v)
    for v in vb:
        pb.add(v)
        rb.add(v)
    pa.merge(pb)
    ra.merge(rb)
    assert pa.counts == ra.counts and pa.count == ra.count == 800
    assert (pa.sum, pa.min, pa.max) == (ra.sum, ra.min, ra.max)
    for q in (0.5, 0.95, 0.99):
        assert pa.quantile(q) == ra.quantile(q)


# -- the aggregator on the same payloads ---------------------------------

@pytest.mark.parametrize("case", ["spans", "windows", "payloads",
                                  "stages_queues", "tenants"])
def test_aggregator_health_equal(case):
    t0 = 1_000_000.0
    if case == "windows":
        a, b = _aggs(window_s=60.0, bucket_s=5.0)
        for agg in (a, b):
            agg.ingest_spans(_spans(2, 10), now=t0)
            agg.ingest_spans(_spans(3, 5), now=t0 + 58.0)
        for now in (t0, t0 + 66.0, t0 + 130.0):
            _same_doc(a.health(now=now), b.health(now=now))
        assert a.health(now=t0 + 130.0)["classes"] == {}
        return
    a, b = _aggs(straggler_z=1.5)
    if case == "spans":
        recs = _spans(4)
        assert a.ingest_spans(recs, now=t0) == \
            b.ingest_spans(recs, now=t0) == len(recs)
        # span-id dedup: replaying the batch is a no-op in both
        assert a.ingest_spans(recs, now=t0 + 1) == \
            b.ingest_spans(recs, now=t0 + 1) == 0
        doc = a.health(now=t0 + 2.0)
        _same_doc(doc, b.health(now=t0 + 2.0))
        # burn rates are compute_burn over the window's counts
        for slo, ent in doc["classes"].items():
            lat = [r["dur_s"] for r in recs if r["name"] == "srv_request"
                   and r["attrs"]["slo"] == slo
                   and r["attrs"]["status"] in ("done", "failed")]
            over = sum(d > SLO_OBJECTIVES[slo]["latency_target_s"]
                       for d in lat)
            bad = ent["shed"] + ent["failed"]
            assert ent["objectives"] == tracing.compute_burn(
                len(lat), over, bad, ent["admitted"], SLO_OBJECTIVES[slo])
        assert any(s["flagged"] for s in doc["stragglers"])
        return
    if case == "payloads":
        recs = _spans(5)
        pays = [{"v": 1, "src": "w0", "seq": 1, "spans": recs[:30],
                 "counters": {"compile_cache_hits_total": 3.0,
                              "serving_transport_reconnect_total": 1.0}},
                {"v": 1, "src": "w0", "seq": 1, "spans": recs[:30]},
                {"src": "w0", "seq": 0},
                {"v": 1, "src": "w1", "seq": 1, "spans": recs[20:],
                 "counters": {"compile_cache_miss_total": 2.0}},
                {"v": 1, "src": "w0", "seq": 2, "spans": [],
                 "counters": {"compile_cache_hits_total": 4.0}},
                "garbage", {"src": "w2", "seq": "nan"}]
        for i, p in enumerate(pays):
            assert a.ingest(p, now=t0 + i) == b.ingest(p, now=t0 + i)
        _same_doc(a.health(now=t0 + 10), b.health(now=t0 + 10))
        return
    if case == "stages_queues":
        for agg in (a, b):
            assert agg.ingest({"src": "w0", "seq": 1, "stages": {
                "0": {"idle_fraction": 0.05}, "1": {"idle_fraction": 0.55}}},
                now=1.0)
            agg.note_queues({"admission": {"interactive": 3},
                             "engine_outstanding_tokens": {"engine0": 128}})
        doc = a.health(now=2.0)
        _same_doc(doc, b.health(now=2.0))
        assert doc["stages"]["flagged"] and \
            doc["stages"]["imbalance"] == pytest.approx(0.5)
        return
    # tenants: ledger deltas over the wire and the router feed
    wire = {"ten0|standard": {"requests": 2, "prefill_tokens": 300,
                              "decode_tokens": 64},
            "ten1|batch": {"requests": 1, "decode_tokens": 16,
                           "kv_page_us": 5_000_000}}
    for agg in (a, b):
        agg.ingest({"src": "w0", "seq": 1, "tenants": wire,
                    "spans": _spans(6, 12)}, now=t0)
        agg.note_tenants({"ten2|interactive": {"requests": 1,
                                               "shed_requests": 1}},
                         {"engine0": {"ten0": 40}})
    _same_doc(a.health(now=t0 + 1), b.health(now=t0 + 1))
    assert a.heavy_hitters(4) == b.heavy_hitters(4)


def test_objectives_and_enabled_match_the_reference(monkeypatch):
    assert SLO_OBJECTIVES == REF_OBJECTIVES
    assert live.SHIP_COUNTERS == ref_live.SHIP_COUNTERS
    monkeypatch.delenv("PADDLE_TPU_LIVE_TELEMETRY", raising=False)
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_DIR", raising=False)
    for flag, tdir in itertools.product(
            (None, "1", "0", "false", "no", "off", "", "yes"),
            (None, "/tmp/t")):
        for k, v in (("PADDLE_TPU_LIVE_TELEMETRY", flag),
                     ("PADDLE_TPU_TELEMETRY_DIR", tdir)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        assert live.live_enabled() == ref_live.live_enabled(), (flag, tdir)


def test_disabled_path_stays_under_budget(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_LIVE_TELEMETRY", raising=False)
    shipper = live.LiveShipper("w0")
    agg = live.LiveAggregator(tail_local=False)
    n = 20_000
    for name, fn in (("live_enabled", live.live_enabled),
                     ("shipper.collect", shipper.collect),
                     ("aggregator.tick", agg.tick),
                     ("note_stage_stats", lambda: live.note_stage_stats({}))):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call = (time.perf_counter() - t0) / n
        assert per_call < 20e-6, f"{name}: {per_call * 1e6:.2f}us/call"


# -- the shipper, the health file, the tick ------------------------------

def _append(path, recs):
    with open(path, "a") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")


def test_shipper_payloads_equal_the_reference(tmp_path, monkeypatch):
    """Both shippers tail the same span file through the same beats: the
    same seq-numbered payloads (spans, counters, stage stats), the same
    ring re-sends, a torn tail left for the next beat."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    span_file = tmp_path / "spans_rank0.jsonl"
    recs = _spans(7, 6)
    a = live.LiveShipper("w0", interval_s=0.0, redundancy=2)
    b = ref_live.LiveShipper("w0", interval_s=0.0, redundancy=2)
    stats = {"0": {"busy_s": 0.5, "wall_s": 1.0, "idle_fraction": 0.5}}

    def strip(pays):
        return None if pays is None else [
            {k: v for k, v in p.items() if k not in ("counters",)}
            for p in pays]

    beats = [recs[:5], [], [], recs[5:12], "torn", [], "stages", []]
    for i, step in enumerate(beats):
        if step == "torn":
            with open(span_file, "a") as f:
                f.write(json.dumps(recs[12])[:20])   # a torn line
        elif step == "stages":
            live.note_stage_stats(stats)
            ref_live.note_stage_stats(stats)
            with open(span_file, "a") as f:
                f.write(json.dumps(recs[12])[20:] + "\n")
        elif step:
            _append(span_file, step)
        got, want = a.collect(now=float(i)), b.collect(now=float(i))
        assert strip(got) == strip(want), i
    assert a._seq == b._seq == 3
    with live._stage_lock:
        live._stage_stats.clear()
    with ref_live._stage_lock:
        ref_live._stage_stats.clear()


def test_health_file_tick_and_events(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    obs.reset()
    try:
        agg = live.LiveAggregator(tail_local=True, health_interval_s=0.0,
                                  burn_event_threshold=1.0, straggler_z=1.5)
        # locally tailed spans: the aggregator polls the telemetry dir
        _append(tmp_path / "spans_rank3.jsonl", _spans(8))
        doc = agg.tick(now=100.0)
        assert doc is not None and doc["classes"]
        path = tmp_path / "fleet_health.json"
        assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
        assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
        kinds = [json.loads(line)["kind"] for line in
                 (tmp_path / "events_rank0.jsonl").read_text().splitlines()]
        assert "slo_burn" in kinds and "rank_straggler" in kinds
        prom = obs.registry().to_prometheus()
        assert "paddle_tpu_slo_burn_rate" in prom
        assert "paddle_tpu_live_health_writes_total 1" in prom
    finally:
        obs.reset()


def test_tele_frames_exactly_once_under_net_chaos(tmp_path, monkeypatch):
    """The port's transport pair beats tele frames through ``net_fence``
    drop and half-open faults: the ring re-sends heal the lost frame,
    the (src, seq) dedup counts every payload once."""
    from paddle_tpu_torch.serving import transport
    from paddle_tpu_torch.serving.transport import (TransportClient,
                                                    TransportServer)

    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    obs.reset()
    span_file = tmp_path / "spans_rank0.jsonl"
    server = TransportServer()
    client = TransportClient(server.addr)
    agg = live.LiveAggregator(tail_local=False)
    shipper = live.LiveShipper("w0", interval_s=0.0, redundancy=64)
    clock = itertools.count(1)
    counts = {"accepted": 0, "attempts": 0}

    def roots(n):
        return [r for r in _spans(int(next(clock)), n)
                if r["name"] == "srv_request"
                and r["attrs"]["status"] == "done"][:n]

    def beat():
        pays = shipper.collect(now=float(next(clock)))
        if pays:
            client.send({"t": "tele", "pays": pays})

    def pump():
        for _cid, frame in server.poll():
            for pay in frame["pays"]:
                counts["attempts"] += 1
                counts["accepted"] += bool(agg.ingest(pay))

    def seen():
        doc = agg.health(now=float(next(clock)))
        return sum(c["requests"] for c in doc["classes"].values())

    def beat_until(want, timeout=10.0):
        deadline = time.monotonic() + timeout
        while seen() < want:
            assert time.monotonic() < deadline, (want, seen(), counts)
            beat()
            pump()
            time.sleep(0.01)

    try:
        first = roots(3)
        _append(span_file, first)
        beat_until(len(first))
        assert counts["accepted"] == 1
        second = roots(2)
        _append(span_file, second)
        monkeypatch.setenv("PADDLE_CHAOS", "1")
        monkeypatch.setenv("PADDLE_CHAOS_NET_MODE", "drop")
        monkeypatch.setenv("PADDLE_CHAOS_NET_AT", "0")
        monkeypatch.setattr(transport, "_send_index", 0)
        assert not client.send(
            {"t": "tele", "pays": shipper.collect(now=float(next(clock)))})
        monkeypatch.delenv("PADDLE_CHAOS_NET_MODE")
        beat_until(len(first) + len(second))
        assert counts["accepted"] == 2
        third = roots(1)
        _append(span_file, third)
        monkeypatch.setenv("PADDLE_CHAOS_NET_MODE", "half_open")
        monkeypatch.setenv("PADDLE_CHAOS_NET_AT", "0")
        monkeypatch.setattr(transport, "_send_index", 0)
        assert client.send(
            {"t": "tele", "pays": shipper.collect(now=float(next(clock)))})
        monkeypatch.delenv("PADDLE_CHAOS_NET_MODE")
        beat_until(len(first) + len(second) + len(third))
        assert counts["accepted"] == 3
        assert counts["attempts"] > counts["accepted"]
    finally:
        client.close()
        server.close()
        obs.reset()


# -- fleet aggregation ----------------------------------------------------

def _snap(rank, step_mean, count=4):
    series = {"count": count, "sum": count * step_mean, "min": step_mean,
              "max": step_mean, "mean": step_mean, "p50": step_mean,
              "p90": step_mean, "p99": step_mean,
              "values": [step_mean] * min(count, 4)}
    return {"rank": rank, "ts": 0.0, "metrics": {
        "train_step_seconds": {"type": "histogram", "help": "",
                               "series": {"": series}},
        "xla_compile_total": {"type": "counter", "help": "",
                              "values": {"where=train_step": 1 + rank}},
        "heartbeat_age_seconds": {"type": "gauge", "help": "",
                                  "values": {f"rank={rank}": 0.1}},
    }}


@pytest.mark.parametrize("factor", [None, "1.1", "3.0", "0.5"])
def test_merge_snapshots_equal(factor, monkeypatch):
    if factor is None:
        monkeypatch.delenv("PADDLE_TPU_STRAGGLER_FACTOR", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_STRAGGLER_FACTOR", factor)
    rng = np.random.default_rng(9)
    snaps = {r: _snap(r, float(rng.uniform(0.01, 0.03)),
                      count=int(rng.integers(0, 50)))
             for r in range(5)}
    snaps[2] = _snap(2, 0.2, count=40)  # the straggler
    del snaps[3]                        # a rank that never published
    got = fleet.merge_snapshots(snaps, world_size=5)
    want = ref_fleet.merge_snapshots(snaps, world_size=5)
    got.pop("ts")
    want.pop("ts")
    assert got == want
    assert got["missing_ranks"] == [3]
    assert fleet.straggler_threshold() == ref_fleet.straggler_threshold()


def test_fleet_sync_over_a_store_and_alone(tmp_path, monkeypatch):
    """Two ranks (threads) publish through the port's TCPStore; rank 0
    merges into fleet_metrics.json and the trace summary; a single
    process writes locally; a file:// rendezvous has no store port."""
    from paddle_tpu_torch.runtime import TCPStore

    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    obs.reset()
    store = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=20.0)
    try:
        obs.observe("train_step_seconds", 0.05)
        _append(tmp_path / "spans_rank0.jsonl", _spans(10, 6))
        paths = {}

        def run(r):
            paths[r] = fleet.fleet_sync(store=store, rank=r, world_size=2,
                                        timeout=20.0, label="t")

        threads = [threading.Thread(target=run, args=(r,)) for r in (1, 0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert paths[1] is None
        doc = json.loads((tmp_path / "fleet_metrics.json").read_text())
        assert paths[0] == str(tmp_path / "fleet_metrics.json")
        assert doc["world_size"] == 2 and doc["missing_ranks"] == []
        assert set(doc["ranks"]) == {"0", "1"}
        summary = json.loads(
            (tmp_path / "fleet_trace_summary.json").read_text())
        want = ref_tracing.summarize_dir(str(tmp_path), REF_OBJECTIVES)
        assert summary["classes"] == json.loads(json.dumps(
            want["classes"]))
        (tmp_path / "fleet_metrics.json").unlink()
        assert fleet.fleet_sync(rank=0, world_size=1) == \
            str(tmp_path / "fleet_metrics.json")
        monkeypatch.setattr(fleet, "_store", None)
        monkeypatch.setenv("PADDLE_MASTER", f"file://{tmp_path}/rdv")
        assert fleet._default_store(0, 1.0) is None
    finally:
        store.close()
        obs.reset()


def test_live_monitor_on_rank0_only(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_LIVE_TELEMETRY", raising=False)
    assert obs.start_live_monitor() is None        # the plane off
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    assert obs.start_live_monitor() is None        # not rank 0
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    obs.reset()
    try:
        _append(tmp_path / "spans_rank0.jsonl", _spans(11, 5))
        agg = obs.start_live_monitor(interval_s=0.05, health_interval_s=0.0)
        assert agg is not None and obs.start_live_monitor() is agg
        deadline = time.monotonic() + 10
        while not (tmp_path / "fleet_health.json").exists():
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        obs.stop_live_monitor()
        obs.reset()
    doc = json.loads((tmp_path / "fleet_health.json").read_text())
    assert doc["classes"]


# -- end to end: a router and two workers with the plane on --------------

def test_router_and_workers_live_plane_reconciles(tmp_path, monkeypatch):
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import EngineWorker, Router

    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    obs.reset()
    with jax_tiny_gpt() as jm:
        tm = torch_tiny_gpt(numpy_state(jm)).eval()
    store = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=20.0)
    eng = dict(num_slots=2, max_length=64, page_size=16, prefix_cache=True,
               device="cpu")
    try:
        workers = [EngineWorker(tm, store, **eng) for _ in range(2)]
        router = Router(store, queue_limit=32, seed=13)
        router._live_agg = live.LiveAggregator(window_s=600.0,
                                               health_interval_s=0.0)
        rng = np.random.default_rng(8)
        slos = ("interactive", "standard", "batch", "interactive",
                "standard", "batch")
        rids = [router.submit(
            rng.integers(1, VOCAB, size=int(n)).astype(np.int64), slo=slo,
            max_new_tokens=6, do_sample=(i % 2 == 1), temperature=0.7,
            top_k=8)
            for i, (slo, n) in enumerate(zip(slos, (14, 23, 31, 11, 19, 9)))]
        deadline = time.monotonic() + 120
        health = None
        while True:
            router.pump()
            for w in workers:
                w.poll_once()
            shipped = {w.name: w._live_shipper._seq for w in workers
                       if w._live_shipper is not None}
            path = tmp_path / "fleet_health.json"
            health = json.loads(path.read_text()) if path.exists() else None
            if (not router.pending() and health and len(shipped) == 2
                    and sum(c["requests"] for c in health["classes"].values())
                    == len(rids)
                    and all(router._live_agg._seen_seq.get(n) == s
                            for n, s in shipped.items())):
                break
            assert time.monotonic() < deadline, (router.stats(), shipped)
        ingested = obs.registry().get("live_ingest_total").snapshot()
        assert sum(ingested["values"].values()) == sum(shipped.values())
        assert set(health["sources"]) == {w.name for w in workers}
        assert set(health["queues"]["engine_outstanding_tokens"]) == \
            {w.name for w in workers}
        summary = ref_tracing.summarize_dir(str(tmp_path), REF_OBJECTIVES)
        assert summary["requests"] == len(rids)
        for slo, s_ent in summary["classes"].items():
            h_ent = health["classes"][slo]
            assert h_ent["requests"] == s_ent["requests"]
            for k in ("frac_over_target", "burn_rate_latency",
                      "frac_unavailable", "burn_rate_availability"):
                assert h_ent["objectives"][k] == pytest.approx(
                    s_ent["objectives"][k], rel=1e-9, abs=1e-12), (slo, k)
            assert h_ent["latency_seconds"]["p95"] == pytest.approx(
                s_ent["latency_seconds"]["p95"], rel=0.05)
        # the streams: one engine of the same config fed the router's params
        single = DecodeEngine(tm, EngineConfig(num_slots=4, max_length=64,
                                               page_size=16,
                                               prefix_cache=True),
                              device="cpu")
        sr = [single.submit(router._requests[r].prompt,
                            router._requests[r].params) for r in rids]
        single.run()
        for r, s in zip(rids, sr):
            assert router.result(r).tolist() == single.result(s).tolist()
        router.shutdown()
        for w in workers:
            w.close()
    finally:
        store.close()
        obs.reset()
