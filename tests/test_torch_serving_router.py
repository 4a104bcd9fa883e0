"""The port's SLO-aware router over in-process engine workers, mirroring
the reference's ``tests/test_serving_router.py`` case for case.

The router and its workers share one interpreter and are driven by hand
(``router.pump()`` interleaved with ``worker.poll_once()``), so every
scheduling decision replays. The tiny GPT is bridged from the reference's
weights. Ground truth comes from two sources, because the reference's
threefry sampling and the port's per-position Philox streams differ:
greedy streams must EQUAL the reference ``DecodeEngine``'s (run once per
module over every greedy request of the file), sampled streams must EQUAL
the port's single ``DecodeEngine`` fed the router's params (its
router-assigned seeds). Exact equality everywhere, except the ``int8`` KV
wire, which is not bit-equal by design. There the first token (sampled
before the wire) is exact, at least 75 % of the tokens decoded after the
wire equal the reference's (the reference test's bar, taken over the
generated tokens of the disaggregated requests only), and every imported
pool element lies within half a quantization level of the exported page
(absmax / 127 of its [layer, page, head] row, recomputed from the export,
widened by 1e-4 for f32 rounding). Controls show both gates can fail:
scales rolled across pages or pages reversed break the element bound,
and zeroed V scales drop the token agreement below the bar.
"""
import numpy as np
import pytest
import torch
from conftest import free_port

from paddle_tpu.inference import engine as ref_engine
from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from paddle_tpu_torch.runtime import TCPStore
from paddle_tpu_torch.serving import EngineWorker, Router

from torch_port_utils import VOCAB, jax_tiny_gpt, numpy_state, torch_tiny_gpt

ENG = dict(num_slots=2, max_length=64, page_size=16, prefix_cache=True,
           device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny CPU models: the suite runs
    6 test processes at once, and 6 pools of spinning threads slowed this
    file's tests up to 20-fold there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).astype(np.int64) for n in lengths]


#: every greedy (prompts, max_new_tokens) whose streams the tests compare
GREEDY = {
    "balanced": (_prompts(1, (20, 33, 17, 25)), 8),
    "disagg": (_prompts(6, (30, 12, 41, 26)), 8),
    "int8": (_prompts(8, (28, 37)), 8),
    "failover": (_prompts(2, (12, 21, 30))[:1], 2),
    "trace": (_prompts(4, (18, 27)), 6),
}


@pytest.fixture(scope="module")
def models():
    with jax_tiny_gpt() as jm:
        yield jm, torch_tiny_gpt(numpy_state(jm)).eval()


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's greedy streams, one run for the module:
    {(prompt tuple, max_new_tokens): stream}."""
    jm, _ = models
    eng = ref_engine.DecodeEngine(jm, attn_kernel="einsum", num_slots=4,
                                  max_length=64, page_size=16,
                                  prefix_cache=True)
    keys = [(tuple(p.tolist()), n) for ps, n in GREEDY.values() for p in ps]
    rids = [eng.submit(np.asarray(k[0]), max_new_tokens=k[1]) for k in keys]
    eng.run()
    return {k: np.asarray(eng.result(r)).tolist() for k, r in zip(keys, rids)}


@pytest.fixture()
def store():
    s = TCPStore(host="127.0.0.1", port=free_port(), is_master=True,
                 timeout=20.0)
    yield s
    s.close()


def _truth(model, reference, router, rids):
    """Expected streams: the reference's for greedy requests, the port's
    single engine (the router's params, so its seeds) for sampled ones."""
    eng = DecodeEngine(model, EngineConfig(num_slots=4, max_length=64,
                                           page_size=16, prefix_cache=True),
                       device="cpu")
    out = {}
    for r in rids:
        req = router._requests[r]
        if req.params.do_sample:
            out[r] = eng.submit(req.prompt, req.params)
    eng.run()
    want = {}
    for r in rids:
        req = router._requests[r]
        if r in out:
            want[r] = eng.result(out[r]).tolist()
        else:
            key = (tuple(req.prompt.tolist()), req.params.max_new_tokens)
            want[r] = reference[key]
    return want


def _drive(router, workers, rounds=2000):
    for _ in range(rounds):
        router.pump()
        for w in workers:
            w.poll_once()
        if not router.pending():
            return
    raise AssertionError(f"undrained after {rounds} rounds: {router.stats()}")


def _submit_mixed(router, prompts, n=8):
    return [router.submit(p, slo="standard", max_new_tokens=n,
                          do_sample=(i % 2 == 0), temperature=0.7, top_k=8)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("dataplane, dispatch_mode", [
    ("streaming", "heap"), ("store", "heap"), ("streaming", "scan")])
def test_dispatch_balances_and_streams_equal(models, reference, store,
                                             dataplane, dispatch_mode):
    _, tm = models
    w0 = EngineWorker(tm, store, **ENG)
    w1 = EngineWorker(tm, store, **ENG)
    router = Router(store, queue_limit=16, seed=5, dataplane=dataplane,
                    dispatch_mode=dispatch_mode)
    rids = _submit_mixed(router, GREEDY["balanced"][0])
    router.pump()
    # least-outstanding-tokens placement spreads the burst
    assert {router._requests[r].engine for r in rids} == {w0.name, w1.name}
    assert all((e.link is None) == (dataplane == "store")
               for e in router._engines.values())
    _drive(router, [w0, w1])
    want = _truth(tm, reference, router, rids)
    for r in rids:
        assert router.result(r).tolist() == want[r]
    st = router.stats()
    assert st["done"] == 4 and st["shed"] == 0


def test_disaggregated_prefill_decode_raw_bit_equal(models, reference, store):
    """1 prefill + 1 decode worker: long prompts prefill on one engine,
    stream their KV pages to the other and decode there; short ones take
    the unified path on the decode worker."""
    _, tm = models
    pw = EngineWorker(tm, store, role="prefill", **ENG)
    dw = EngineWorker(tm, store, role="decode", **ENG)
    router = Router(store, queue_limit=16, seed=5,
                    prefill_threshold_tokens=24)
    prompts = GREEDY["disagg"][0]
    rids = [router.submit(p, slo="standard", max_new_tokens=8,
                          do_sample=(i % 2 == 0), temperature=0.8, top_k=8)
            for i, p in enumerate(prompts)]
    _drive(router, [pw, dw])
    st = router.stats()
    assert st["done"] == 4 and st["shed"] == 0
    assert st["disagg_dispatches"] == 3
    assert all(router._requests[r].engine == dw.name for r in rids)
    want = _truth(tm, reference, router, rids)
    for r in rids:
        assert router.result(r).tolist() == want[r]
    assert pw.engine.stats()["decode_steps"] == 0  # prefill never decodes
    assert dw.engine.stats()["prefill_calls"] == 1  # the short prompt
    assert pw.engine.occupancy()["running"] == 0
    assert dw.engine.occupancy()["running"] == 0


def _wire_excess(exported, imported):
    """Largest ``|imported - exported|`` over its int8-wire bound, half a
    quantization level: absmax / 127 of the element's [layer, page, head]
    row of the EXPORTED pages, widened by 1e-4 for f32 rounding. At most 1
    when every page came back in its place at its own scale."""
    x = np.asarray(exported, np.float64)
    level = np.abs(x).max(axis=(-2, -1), keepdims=True) / 127.0
    bound = np.maximum(0.5 * level * (1 + 1e-4), np.finfo(np.float32).tiny)
    return float((np.abs(np.asarray(imported, np.float64) - x) / bound).max())


def _run_disagg(tm, store, prompts, n, ns):
    """Route ``prompts`` greedily through 1 prefill + 1 decode worker on
    the int8 KV wire, in namespace ``ns``; record each prefill's exported pages and the decode
    pool's pages right after the import, by prompt length."""
    pw = EngineWorker(tm, store, role="prefill", kv_wire="int8",
                      namespace=ns, **ENG)
    dw = EngineWorker(tm, store, role="decode", namespace=ns, **ENG)
    exported, imported = {}, {}
    export, import_ = pw.engine.prefill_export, dw.engine.try_import_prefill

    def spy_export(prompt, *a, **kw):
        out = export(prompt, *a, **kw)
        if out is not None and "k" in out:
            exported[len(prompt)] = (out["k"], out["v"])
        return out

    def spy_import(prompt, *a, **kw):
        rid = import_(prompt, *a, **kw)
        if rid is not None:
            pages = dw.engine._requests[rid].page_ids[:len(exported[len(
                prompt)][0][0])]
            imported[len(prompt)] = (dw.engine._kc[:, pages].numpy().copy(),
                                     dw.engine._vc[:, pages].numpy().copy())
        return rid

    pw.engine.prefill_export = spy_export
    dw.engine.try_import_prefill = spy_import
    router = Router(store, namespace=ns, queue_limit=16, seed=5,
                    prefill_threshold_tokens=24)
    rids = [router.submit(p, slo="standard", max_new_tokens=n)
            for p in prompts]
    _drive(router, [pw, dw])
    st = router.stats()
    assert st["done"] == len(prompts)
    assert st["disagg_dispatches"] == len(prompts)
    return router, rids, exported, imported


def _generated_agreement(router, rids, prompts, want):
    agree = total = 0
    for r, p in zip(rids, prompts):
        got, w = router.result(r), np.asarray(want[r])
        assert got.shape == w.shape
        agree += int(np.sum(got[len(p):] == w[len(p):]))
        total += int(w.size - len(p))
    return agree / total


def test_disaggregated_int8_kv_wire_trajectory(models, reference, store,
                                               monkeypatch):
    from paddle_tpu_torch.serving import transport
    from paddle_tpu_torch.serving import worker as worker_mod

    _, tm = models
    prompts, n = GREEDY["int8"]
    router, rids, exported, imported = _run_disagg(tm, store, prompts, n,
                                                   "int8")
    want = _truth(tm, reference, router, rids)
    for r, p in zip(rids, prompts):
        # the prefill-side token rides the wire as a plain int: exact
        assert router.result(r)[len(p)] == want[r][len(p)]
    # the gate reads only tokens decoded over the imported pages
    assert _generated_agreement(router, rids, prompts, want) >= 0.75
    # every imported element within half a level of its exported page;
    # the wire did quantize (not a raw copy)
    for t in (len(p) for p in prompts):
        for e, i in zip(exported[t], imported[t]):
            assert 0.0 < _wire_excess(e, i) <= 1.0
    # controls: a scale layout or page order gone wrong breaks the bound
    k, v = exported[len(prompts[0])]
    assert k.shape[1] >= 2
    payload = transport.encode_kv(k, v, "int8")
    rolled = dict(payload, k_scale=np.roll(payload["k_scale"], 1, axis=1))
    assert _wire_excess(k, transport.decode_kv(rolled)["k"]) > 1.0
    flipped = dict(payload, k=payload["k"][:, ::-1].copy())
    assert _wire_excess(k, transport.decode_kv(flipped)["k"]) > 1.0
    # ... and V pages read back at a zero scale break the token gate
    real_decode = transport.decode_kv

    def zero_v(payload):
        return real_decode(dict(payload, v_scale=payload["v_scale"] * 0))

    monkeypatch.setattr(worker_mod, "decode_kv", zero_v)
    router, rids, _, _ = _run_disagg(tm, store, prompts, n, "control")
    bad = _generated_agreement(router, rids, prompts,
                               _truth(tm, reference, router, rids))
    assert bad < 0.75


def test_failover_no_loss_no_dup(models, reference, store):
    """Kill an engine with work in flight: its finished result is
    harvested (done-before-ack), unfinished work reruns elsewhere and
    equals the ground truth, nothing completes twice."""
    _, tm = models
    victim = EngineWorker(tm, store, **ENG)
    router = Router(store, queue_limit=16, engine_grace_s=0.05, seed=9)
    prompts = _prompts(2, (12, 21, 30))
    rids = [router.submit(prompts[0], slo="interactive", max_new_tokens=2),
            router.submit(prompts[1], slo="standard", max_new_tokens=12,
                          do_sample=True, temperature=0.8, top_k=8),
            router.submit(prompts[2], slo="standard", max_new_tokens=12,
                          do_sample=True, temperature=0.8, top_k=8)]
    router.pump()
    assert all(router._requests[r].engine == victim.name for r in rids)
    for _ in range(50):
        victim.poll_once()
        if victim.engine._requests[0].status == "done":
            break
    assert victim.engine._requests[0].status == "done"
    router.config.engine_grace_s = 0.0
    router.pump()
    router.config.engine_grace_s = 5.0
    st = router.stats()
    assert st["engines_lost"] == 1
    assert router.status(rids[0]) == "done"
    assert st["failover_resubmits"] == 2
    survivor = EngineWorker(tm, store, **ENG)
    _drive(router, [survivor])
    st = router.stats()
    assert st["done"] == 3 and st["shed"] == 0
    assert st["dispatched"] == 3 + st["failover_resubmits"] == 5
    want = _truth(tm, reference, router, rids)
    for r in rids:
        assert router.result(r).tolist() == want[r]


def _affinity_pair(seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, VOCAB, size=32, dtype=np.int64)  # 2 pages
    a = np.concatenate([prefix, rng.integers(1, VOCAB, size=5)])
    b = np.concatenate([prefix, rng.integers(1, VOCAB, size=9)])
    return a.astype(np.int64), b.astype(np.int64)


@pytest.mark.parametrize("slack, hits", [(512, 1), (1, 0)])
def test_prefix_affinity_and_load_skew(models, store, slack, hits):
    _, tm = models
    w0 = EngineWorker(tm, store, **ENG)
    w1 = EngineWorker(tm, store, **ENG)
    router = Router(store, queue_limit=16, affinity_slack_tokens=slack,
                    seed=1)
    a, b = _affinity_pair(3 if hits else 4)
    ra = router.submit(a, slo="standard", max_new_tokens=6)
    router.pump()
    rb = router.submit(b, slo="standard", max_new_tokens=6)
    router.pump()
    same = router._requests[rb].engine == router._requests[ra].engine
    # within the slack the cached prefix wins; past it, load does
    assert same == bool(hits)
    assert router.stats()["affinity_hits"] == hits
    _drive(router, [w0, w1])
    assert router.stats()["done"] == 2
    if hits:
        eng = (w0 if router._requests[ra].engine == w0.name else w1).engine
        assert eng.prefix_hit_tokens == 32


def test_overload_sheds_lowest_slo_first():
    router = Router(None, queue_limit=2)
    b1 = router.submit([1, 2, 3], slo="batch", max_new_tokens=4)
    b2 = router.submit([4, 5, 6], slo="batch", max_new_tokens=4)
    i1 = router.submit([7, 8, 9], slo="interactive", max_new_tokens=4)
    assert router.status(b2) == "shed"
    assert router._requests[b2].shed_reason == "queue_full"
    assert router.status(i1) == "queued"
    s1 = router.submit([1, 1, 1], slo="standard", max_new_tokens=4)
    assert router.status(b1) == "shed" and router.status(s1) == "queued"
    b3 = router.submit([2, 2, 2], slo="batch", max_new_tokens=4)
    assert router.status(b3) == "shed"
    with pytest.raises(RuntimeError, match="queue_full"):
        router.result(b3)
    assert router.stats()["shed"] == 3
    with pytest.raises(ValueError, match="SLO class"):
        router.submit([1], slo="gold")


def test_deadline_expired_requests_are_shed(models, store):
    _, tm = models
    EngineWorker(tm, store, **ENG)
    router = Router(store, queue_limit=8, deadlines={"standard": 0.0})
    rid = router.submit([1, 2, 3, 4], slo="standard", max_new_tokens=4)
    router.pump()
    assert router.status(rid) == "shed"
    assert router._requests[rid].shed_reason == "deadline"
    with pytest.raises(RuntimeError, match="deadline"):
        router.result(rid)


def test_shutdown_broadcast_reaches_workers(models, store):
    _, tm = models
    w = EngineWorker(tm, store, **ENG)
    router = Router(store)
    assert not w.stop_requested()
    router.shutdown()
    assert w.stop_requested()
    w.serve()  # returns at once: the stop is already broadcast


def test_unported_serving_knobs_raise(models, store, monkeypatch, tmp_path):
    """The knobs that once raised are ported: the front tier imports from
    ``serving`` (``tests/test_torch_frontier.py`` holds it), and the
    worker CLI takes ``--step-floor-ms``, a worker paced to that floor."""
    import time

    _, tm = models
    import paddle_tpu_torch.serving as serving
    from paddle_tpu_torch.serving import frontier, worker as worker_mod
    from paddle_tpu_torch.serving.protocol import k_count
    from paddle_tpu_torch.serving.transport import TransportClient

    assert serving.FrontierRouter is frontier.FrontierRouter
    assert serving.rendezvous_rank is frontier.rendezvous_rank
    assert worker_mod.build_arg_parser().parse_args(
        ["--step-floor-ms", "5"]).step_floor_ms == 5.0
    # the CLI with the floor registers a worker and serves until the stop
    # (already broadcast here, so it returns at once)
    Router(store, namespace="floor_cli").shutdown()
    assert worker_mod.main(
        ["--step-floor-ms", "5", "--device", "cpu", "--namespace",
         "floor_cli", "--master", f"127.0.0.1:{store.port}"]) == 0
    assert store.add(k_count("floor_cli"), 0) == 1  # one registered
    paced = EngineWorker(tm, store, namespace="floor", step_floor_s=0.005,
                         **ENG)
    floor_router = Router(store, namespace="floor")
    floor_router.submit([1, 2, 3, 4], max_new_tokens=6)
    busy = []
    for _ in range(200):
        floor_router.pump()
        t0 = time.monotonic()
        if paced.poll_once():
            busy.append(time.monotonic() - t0)
        if not floor_router.pending():
            break
    assert not floor_router.pending() and len(busy) >= 3
    assert min(busy) >= 0.005, busy
    paced.close()
    router = Router(store)
    w = EngineWorker(tm, store, **ENG)
    # a wt frame (serving/online.py) is applied between steps and acked
    link = TransportClient(w._server.addr)
    assert link.send({"t": "wt", "ch": "wt", "seq": 0, "kind": "begin",
                      "epoch": 1})
    acks = []
    for _ in range(200):
        w.poll_once()
        acks += [f for f in link.poll() if f.get("t") == "wt_ack"]
        if acks:
            break
    assert acks[0]["kind"] == "begin" and acks[0]["applied"]
    assert acks[0]["live"] == 0 and w.engine._shadow["epoch"] == 1
    link.close()
    # the live plane is ported (tests/test_torch_live_telemetry.py): under
    # the flag a pump builds the router's aggregator and ticks it; an
    # aggregator shared by another owner takes the wire's tele payloads
    # while this router neither drives its tick nor writes its queues
    from paddle_tpu_torch.observability import live

    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    router.pump()
    assert isinstance(router._live_agg, live.LiveAggregator)
    assert (tmp_path / "fleet_health.json").exists()
    shared = live.LiveAggregator(tail_local=False)
    router.share_live_aggregator(shared)
    assert router._live_agg is shared and not router._live_driver
    from paddle_tpu_torch import observability as obs

    obs.record_span("compile", dur_s=0.01)  # something for w to ship
    for _ in range(200):
        router.pump()
        w.poll_once()
        if w.name in shared._seen_seq:
            break
    assert shared._seen_seq.get(w.name, 0) >= 1
    assert shared.health()["queues"] == {}


def test_request_trace_tree_and_done_event(models, reference, store,
                                           tmp_path, monkeypatch):
    """Telemetry on: every routed request is ONE span tree across router,
    worker and engine — checked by the reference's own
    ``tracing.validate_trees`` / ``summarize_dir`` on the port's span
    files — the done event carries the phase breakdown, and the streams
    stay equal to the untraced ground truth."""
    import json

    from paddle_tpu.observability import tracing as ref_tracing
    from paddle_tpu.serving.protocol import SLO_OBJECTIVES
    from paddle_tpu_torch import observability as obs

    _, tm = models
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    obs.reset()
    try:
        w = EngineWorker(tm, store, **ENG)
        router = Router(store, queue_limit=16, seed=3)
        prompts = GREEDY["trace"][0]
        rids = [router.submit(p, slo=slo, max_new_tokens=6)
                for p, slo in zip(prompts, ("interactive", "batch"))]
        _drive(router, [w])

        spans = ref_tracing.load_spans(str(tmp_path))
        assert ref_tracing.validate_trees(spans) == []
        roots = [s for s in spans if s["name"] == "srv_request"]
        assert len(roots) == 2 and all(not s.get("parent_id") for s in roots)
        assert {s["attrs"]["status"] for s in roots} == {"done"}
        assert {s["attrs"]["slo"] for s in roots} == {"interactive", "batch"}
        for root in roots:
            names = {s["name"] for s in spans
                     if s["trace_id"] == root["trace_id"]}
            assert {"srv_request", "srv_admit", "srv_queue",
                    "srv_dispatch", "srv_net_transit", "srv_drain",
                    "srv_prefill", "srv_decode"} <= names
            assert "srv_store_transit" not in names
        summary = ref_tracing.summarize_dir(str(tmp_path), SLO_OBJECTIVES)
        assert summary["requests"] == 2 and summary["unfinished"] == 0
        assert set(summary["classes"]) == {"interactive", "batch"}
        evs = [json.loads(line) for line in
               (tmp_path / "events_rank0.jsonl").read_text().splitlines()]
        done = [e for e in evs if e["kind"] == "serving_request_done"]
        assert len(done) == 2
        for e in done:
            assert e["queue_s"] >= 0 and e["prefill_s"] > 0
            assert e["decode_s"] >= 0
            assert e["spec_accepted"] == 0 and e["resubmitted"] is False
        prom = (tmp_path / "metrics_rank0.prom")
        obs.flush()
        assert "paddle_tpu_serving_router_dispatch_total 2" in \
            prom.read_text()
        want = _truth(tm, reference, router, rids)
        for r in rids:
            assert router.result(r).tolist() == want[r]
    finally:
        obs.reset()
