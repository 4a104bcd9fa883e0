"""The port's coordination store, chaos harness and telemetry layer against
the reference's.

``runtime.TCPStore`` (on ``torch.distributed.TCPStore``) and its
pure-Python path run the same scripted operations as the reference's
``PyTCPStore`` and give the same answers (values, ``add`` counts, ``check``
/ ``delete_key`` booleans, ``TimeoutError`` on a missing key within
[timeout, timeout + 2 s]); the metrics registry's snapshot and Prometheus
text equal the reference's after the same calls (exact: the same floats
go through the same arithmetic); the tenant ledger, the page-seconds meter
and the space-saving sketch equal the reference's on a scripted sequence
(exactly, floats included); every metric the port records is in
the reference's catalog with the same kind.
"""
import ast
import os
import threading
import time
from pathlib import Path

import pytest

from paddle_tpu.observability import accounting as ref_acct
from paddle_tpu.observability import catalog as ref_catalog
from paddle_tpu.observability.metrics import MetricsRegistry as RefRegistry
from paddle_tpu.runtime.py_store import PyTCPStore as RefPyStore
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import accounting, catalog
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.runtime import TCPStore, store_torch_enabled
from paddle_tpu_torch.runtime.py_store import PyTCPStore
from paddle_tpu_torch.testing import chaos

ROOT = Path(__file__).resolve().parents[1]


def _script(store, other):
    """The same operations on ``store`` (the master) and ``other`` (a
    client of it); returns what each returned."""
    out = []
    store.set("a", "x")
    store.set("b", b"\x00\x01")
    out.append(other.get("a", 5.0))
    out.append(other.get("b", 5.0))
    out.append(store.add("n", 3))
    out.append(other.add("n", 4))
    out.append(store.add("n", 0))
    out.append(other.check("a"))
    out.append(other.check("zz"))
    out.append(store.delete_key("a"))
    out.append(store.delete_key("a"))
    out.append(other.check("a"))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        other.get("never", 0.3)
    out.append(0.3 <= time.monotonic() - t0 < 2.3)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        store.wait("never", 0.2)
    out.append(0.2 <= time.monotonic() - t0 < 2.2)
    # a get waits for a key another client sets later
    timer = threading.Timer(0.2, lambda: store.set("late", b"ok"))
    timer.start()
    out.append(other.get("late", 5.0))
    timer.join()
    return out


def _barrier(make_client, port, n=3):
    clients = [make_client(port) for _ in range(n)]
    errs = []

    def run(c):
        try:
            c.barrier("b0", n, timeout=10.0)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15.0)
    for c in clients:
        c.close()
    return errs


def test_store_semantics_equal_reference_py_store(monkeypatch):
    ref = RefPyStore("127.0.0.1", 0, is_master=True, timeout=10.0)
    ref_client = RefPyStore("127.0.0.1", ref.port, timeout=10.0)
    want = _script(ref, ref_client)
    ref_client.close()
    ref.close()
    assert want[0] == b"x" and want[2:5] == [3, 7, 7]

    assert store_torch_enabled()
    master = TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
    assert master._store is not None and master.port > 0
    client = TCPStore("127.0.0.1", master.port, timeout=10.0)
    assert _script(master, client) == want
    assert _barrier(lambda p: TCPStore("127.0.0.1", p, timeout=10.0),
                    master.port) == []
    client.close()
    master.close()

    # PADDLE_STORE_FORCE_PY takes the Python store, same answers
    monkeypatch.setenv("PADDLE_STORE_FORCE_PY", "1")
    assert not store_torch_enabled()
    master = TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
    assert isinstance(master._py_fallback, PyTCPStore)
    client = TCPStore("127.0.0.1", master.port, timeout=10.0)
    assert _script(master, client) == want
    assert _barrier(lambda p: TCPStore("127.0.0.1", p, timeout=10.0),
                    master.port) == []
    client.close()
    master.close()


def test_asymmetric_handshake_master_finishes_last():
    master = TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
    clients = [TCPStore("127.0.0.1", master.port, timeout=10.0)
               for _ in range(2)]
    errs = []

    def run(store, rank):
        try:
            store.asymmetric_handshake("hs", rank, 3, timeout=10.0)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(s, r))
               for r, s in enumerate([master] + clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15.0)
    assert not any(t.is_alive() for t in threads) and errs == []
    assert all(master.check(f"hs/ack/{r}") for r in (1, 2))
    with pytest.raises(TimeoutError, match="rank 1 of 2 never arrived"):
        master.asymmetric_handshake("hs2", 0, 2, timeout=0.2)
    for c in clients:
        c.close()
    master.close()


def test_chaos_store_faults_force_python_store_and_retry(monkeypatch):
    monkeypatch.setenv("PADDLE_CHAOS", "1")
    monkeypatch.setenv("PADDLE_CHAOS_STORE_DROP", "0.5")
    monkeypatch.setenv("PADDLE_CHAOS_SEED", "3")
    chaos.reset()
    try:
        assert chaos.store_faults_enabled() and not store_torch_enabled()
        master = TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
        assert master._py_fallback is not None
        # dropped connections before idempotent ops are re-issued
        for i in range(12):
            master.set(f"k{i}", str(i))
            assert master.get(f"k{i}", 5.0) == str(i).encode()
        master.close()
    finally:
        chaos.reset()


def test_store_connect_failure_is_connection_error():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(ConnectionError):
        TCPStore("127.0.0.1", port, timeout=0.5)


def test_chaos_fences_inert_without_env_and_deterministic(monkeypatch):
    monkeypatch.delenv("PADDLE_CHAOS", raising=False)
    assert chaos.net_fence(0) is None
    chaos.engine_fence(0)  # no-op
    monkeypatch.setenv("PADDLE_CHAOS", "1")
    monkeypatch.setenv("PADDLE_CHAOS_NET_MODE", "drop")
    monkeypatch.setenv("PADDLE_CHAOS_NET_AT", "2")
    assert [chaos.net_fence(i) for i in range(4)] == [None, None, "drop",
                                                       None]
    monkeypatch.setenv("PADDLE_RESTART_COUNT", "1")
    assert chaos.net_fence(2) is None  # PADDLE_CHAOS_ONCE: clean relaunch


def _record(reg):
    reg.counter("store_reconnect_total").inc()
    reg.counter("serving_tokens_total").inc(5)
    reg.counter("serving_transport_frames_total").inc(1, dir="send",
                                                      kind="kv")
    reg.counter("serving_transport_frames_total").inc(2, dir="recv",
                                                      kind="occ")
    reg.gauge("serving_queue_depth").set(3)
    reg.gauge("serving_kv_pages_free").set(17.5)
    for i, v in enumerate((0.5, 0.125, 2.0, 0.25, 1e-3)):
        reg.histogram("serving_decode_step_seconds").observe(v)
        reg.histogram("store_op_seconds").observe(v * (i + 1), op="get")
    reg.gauge("tenant_tokens").set(4, tenant="acme", kind="decode")


def test_metrics_registry_snapshot_and_prometheus_equal_reference():
    ref = RefRegistry(catalog=ref_catalog.METRICS)
    got = MetricsRegistry(catalog=catalog.METRICS)
    _record(ref)
    _record(got)
    assert got.snapshot() == ref.snapshot()
    assert got.to_prometheus() == ref.to_prometheus()
    with pytest.raises(ValueError):
        got.gauge("serving_tokens_total")  # catalog kind is counter


def test_env_gated_helpers_and_event_log(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_DIR", raising=False)
    obs.reset()
    obs.inc("serving_tokens_total", 3)
    assert obs.registry().get("serving_tokens_total") is None
    assert obs.flush() is None
    assert not obs.start_span("srv_request")
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    try:
        obs.inc("serving_tokens_total", 3)
        obs.event("serving_request_done", req_id=1)
        path = obs.flush()
        assert "paddle_tpu_serving_tokens_total 3" in Path(path).read_text()
        assert (tmp_path / "events_rank0.jsonl").exists()
    finally:
        obs.reset()


def test_live_telemetry_raises_naming_roadmap(monkeypatch, tmp_path):
    """The live plane and the fleet merge are ported (ROADMAP.md §A.8's
    items; tests/test_torch_live_telemetry.py holds them against the
    reference): under the flag rank 0's monitor runs and writes
    ``fleet_health.json``; with the flag off it stays down; the package
    exports the reference's fleet names."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "0")
    assert obs.start_live_monitor() is None
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    agg = obs.start_live_monitor(interval_s=0.02, health_interval_s=0.0)
    try:
        assert agg is not None
        deadline = time.monotonic() + 10
        while not (tmp_path / "fleet_health.json").exists():
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        obs.stop_live_monitor()
        obs.reset()
    assert not hasattr(obs, "check_live_unported")
    doc = obs.merge_snapshots({0: obs.snapshot()}, world_size=2)
    assert doc["missing_ranks"] == [1]


class _Req:
    def __init__(self, tenant, slo, pages):
        self.tenant, self.slo, self.page_ids = tenant, slo, pages
        self.acct_page_us = 0


def _ledger_script(mod):
    led = mod.TenantLedger(max_cells=4)
    meter = mod.PageSecondsMeter(led)
    refs = {1: 2, 2: 1, 3: 1, 4: 3}
    running = [_Req("acme", "interactive", [1, 2]),
               _Req("-", "batch", [1, 3, 4])]
    meter.tick(10.0, running, lambda p: refs.get(p, 0), 6)
    meter.tick(10.25, running, lambda p: refs.get(p, 0), 6)
    meter.tick(10.7500001, running[:1], lambda p: refs.get(p, 0), 5)
    for i, t in enumerate(("acme", "beta", "gamma", "delta", "eps")):
        led.add(mod.normalize_tenant(t), "standard", requests=1,
                prefill_tokens=10 * i, decode_tokens=i,
                queue_seconds=0.1 * i)
    led.add(mod.normalize_tenant("  a|b c "), "batch", shed_requests=1)
    sk = mod.SpaceSavingSketch(3)
    for key, w in (("a", 5), ("b", 1), ("c", 2), ("d", 7), ("a", 1),
                   ("e", 3)):
        sk.offer(key, w)
    sk2 = mod.SpaceSavingSketch(2)
    sk2.offer("a", 4)
    sk2.offer("z", 9)
    return (led.cells(), led.fleet(), led.per_tenant(), led.folded_tenants,
            led.collect_delta(), led.snapshot_wire(), meter.total_page_us,
            [r.acct_page_us for r in running], sk.topk(),
            sk.merge(sk2).topk(), mod.normalize_tenant(None),
            mod.normalize_tenant("x" * 80))


def test_tenant_ledger_arithmetic_equals_reference():
    got = _ledger_script(accounting)
    want = _ledger_script(ref_acct)
    assert got == want
    # the page integral charged and tenants folded into "~" past 4 cells
    assert got[6] > 0 and got[3] > 0


def _recorded_metrics():
    """(name, kind) of every literal metric name the port records."""
    kinds = {"inc": "counter", "set_gauge": "gauge", "observe": "histogram",
             "counter": "counter", "gauge": "gauge",
             "histogram": "histogram"}
    found = set()
    for path in (ROOT / "paddle_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in kinds
                    and isinstance(getattr(node.func, "value", None),
                                   ast.Name)
                    and node.func.value.id == "_obs" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                found.add((node.args[0].value, kinds[node.func.attr]))
    return found


def test_port_metric_names_are_in_the_reference_catalog():
    found = _recorded_metrics()
    names = {n for n, _ in found}
    # the serving tier's families are all there
    for n in ("serving_requests_total", "serving_decode_step_seconds",
              "serving_router_dispatch_total", "serving_transport_bytes_total",
              "store_op_seconds", "chaos_fault_total"):
        assert n in names, n
    for name, kind in found:
        assert ref_catalog.metric_kind(name) == kind, (name, kind)
    assert catalog.METRICS == ref_catalog.METRICS
    assert catalog.EVENTS == ref_catalog.EVENTS
    assert set(catalog.SPANS) == set(ref_catalog.SPANS)
    for name, (owner, _) in catalog.SPANS.items():
        assert owner == ref_catalog.SPANS[name][0].replace(
            "paddle_tpu/", "paddle_tpu_torch/", 1)
    assert os.path.exists(ROOT / catalog.span_owner("srv_request"))
