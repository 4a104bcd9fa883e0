"""The port's fleet supervisor (``paddle_tpu_torch/distributed/fleet/
supervisor.py``) held against the reference's
(``paddle_tpu/distributed/fleet/supervisor.py``), mirroring
``tests/test_supervisor.py`` and ``tests/test_supervisor_chaos.py``.

The state machine runs in both packages on the same scripted inputs
(health documents, clocks, executors that record their calls or raise at
a fence): the journal documents, the roles documents, the flip history,
``recover`` at every fence, ``decide`` through hysteresis / cooldown /
``min_serving`` and the breaker, and the executor's call order must be
EQUAL, timestamps and flip ids aside (both are the wall clock's). Flip
prices come from each package's MPMD stage planner; the tests give both
the same cost constants (``torch_port_utils.same_planner_constants``),
and the prices then compare within 1e-12 relative.

On the CPU: a port ``Router`` and two ``EngineWorker`` s with the live
plane on, the supervisor flipping one worker to training on the plane's
own ``fleet_health.json`` (a drain, then ``Router.evacuate``) and back on
a backlog; every request done once, streams equal one engine. Then a
scripted supervisor SIGKILLed at ``resize`` (before the commit fence:
rolled back) and at ``commit`` (at it: rolled forward), each relaunch
recovering a trajectory bit-equal to an unkilled run. The reference's
all-fence soak has its counterpart below, marked slow and chaos as the
reference's is.
"""
import copy
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from conftest import free_port

from paddle_tpu.distributed.fleet import supervisor as ref
from paddle_tpu_torch.distributed.fleet import supervisor as port

from torch_port_utils import (VOCAB, jax_tiny_gpt, numpy_state,
                              same_planner_constants, torch_tiny_gpt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLOCK = ("ts", "closed_ts", "fences", "id", "plan_seconds")


def _scrub(doc):
    """A journal / roles / history document without its wall-clock
    fields (fence timestamps, close time, the time-seeded flip id, the
    planner's own timing, the breaker's wall-clock deadline): what must
    be equal across the packages."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "fences" and isinstance(v, dict):
                out[k] = sorted(v)
            elif k == "breaker_open_until":
                out[k] = bool(v)
            elif k not in _CLOCK:
                out[k] = _scrub(v)
        return out
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    return doc


def _health(burn=0.0, backlog=0):
    return {"classes": {"interactive": {"objectives": {
        "burn_rate_latency": burn, "burn_rate_availability": 0.0}}},
        "queues": {"admission": {"interactive": backlog}}}


def _recorder(pkg, fail_at=None, drain_clean=True):
    class RecordingExecutor(pkg.FlipExecutor):
        def __init__(self):
            self.calls = []

        def _hit(self, name, *args):
            self.calls.append((name,) + args)
            if name == fail_at:
                raise RuntimeError(f"injected {name} failure")

        def drain(self, engine, deadline_s):
            self._hit("drain", engine)
            return drain_clean

        def quiesce(self, engine):
            self._hit("quiesce", engine)

        def resize(self, source_width, target_width):
            self._hit("resize", source_width, target_width)

        def activate(self, engine, role):
            self._hit("activate", engine, role)

        def rollback(self, doc):
            self._hit("rollback", doc.get("engine"))

    return RecordingExecutor()


def _pair(tmp_path, roles=None, width=0, fail_at=None, **cfg):
    cfg.setdefault("hysteresis_s", 0.0)
    cfg.setdefault("cooldown_s", 0.0)
    out = []
    for pkg in (port, ref):
        ex = _recorder(pkg, fail_at)
        out.append(pkg.FleetSupervisor(
            str(tmp_path / pkg.__name__.split(".")[0] / "journal"),
            executor=ex, config=pkg.SupervisorConfig(**cfg),
            roles=dict(roles or {"e0": "serving", "e1": "serving"}),
            training_width=width))
    return out


def _same_state(a, b):
    assert _scrub(a.roles_doc) == _scrub(b.roles_doc)
    assert _scrub(a.journal.history()) == _scrub(b.journal.history())
    assert _scrub(a.journal.pending()) == _scrub(b.journal.pending())
    assert a.executor.calls == b.executor.calls
    assert a.last_outcome == b.last_outcome


# -- the journal -----------------------------------------------------------

def test_constants_match():
    assert port.FENCES == ref.FENCES and port.COMMIT_INDEX == \
        ref.COMMIT_INDEX
    assert port.WEIGHT_FENCES == ref.WEIGHT_FENCES
    assert port.WEIGHT_COMMIT_INDEX == ref.WEIGHT_COMMIT_INDEX
    assert vars(port.SupervisorConfig()) == vars(ref.SupervisorConfig())


@pytest.mark.parametrize("kind", ["flip", "weights"])
def test_journal_documents_equal(tmp_path, kind):
    """The same transaction through both journals: every intermediate
    document, the history and the atomic files (no tmp litter) equal."""
    docs = []
    for pkg in (port, ref):
        j = pkg.FlipJournal(str(tmp_path / pkg.__name__.split(".")[0]))
        seen = []
        if kind == "flip":
            doc = {"id": 7, "direction": "to_training", "engine": "e1",
                   "reason": "r", "source_width": 0, "target_width": 1,
                   "price": {"approve": True}}
            j.begin(doc)
            seen.append(_scrub(j.pending()))
            for fence in pkg.FENCES[1:]:
                j.advance(doc, fence)
                seen.append(_scrub(j.pending()))
            with pytest.raises(ValueError):
                j.advance(doc, "nope")
            j.close(doc, "committed")
            j.close(doc, "committed")   # re-closing is idempotent
            seen += [j.pending(), _scrub(j.history())]
        else:
            doc = {"id": 3, "epoch": 2, "engines": ["e0"], "leaves": 4,
                   "wire": "bf16", "bytes": 1024, "acked": []}
            j.begin_weights(doc)
            for fence in pkg.WEIGHT_FENCES[1:]:
                j.advance_weights(doc, fence)
                seen.append(_scrub(j.pending_weights()))
            with pytest.raises(ValueError):
                j.advance_weights(doc, "nope")
            j.close_weights(doc, "committed")
            seen += [j.pending_weights(), _scrub(j.weight_history())]
        assert not [f for f in os.listdir(j.root) if ".tmp." in f]
        docs.append(seen)
    assert docs[0] == docs[1]


def test_read_health_tolerates_missing_and_torn(tmp_path):
    p = tmp_path / "fleet_health.json"
    assert port.read_health(str(p)) == ref.read_health(str(p)) == {}
    p.write_text('{"classes": {')
    assert port.read_health(str(p)) == ref.read_health(str(p)) == {}
    p.write_text(json.dumps(_health(0.3, 2)))
    assert port.read_health(str(p)) == ref.read_health(str(p))
    for h in (_health(), _health(2.5, 0), _health(0.1, 9), {},
              {"queues": {"admission": 3}}):
        assert port.FleetSupervisor._signals(h) == \
            ref.FleetSupervisor._signals(h)


# -- recovery at every fence ---------------------------------------------

@pytest.mark.parametrize("fence", port.FENCES)
def test_recover_at_every_fence_equal(tmp_path, fence, monkeypatch):
    """A flip left at ``fence`` by a dead supervisor: both recover it the
    same way (back before ``commit``, forward at and after it)."""
    same_planner_constants(monkeypatch)
    sups = _pair(tmp_path)
    for s in sups:
        d = s.decide(_health(), now=0.0)
        src = s.roles_doc
        tgt = copy.deepcopy(src)
        tgt["roles"][d.engine] = "training"
        tgt["training_width"] = 1
        tgt["flips_committed"] = 1
        doc = {"id": 1, "direction": d.direction, "engine": d.engine,
               "reason": d.reason, "price": d.price,
               "source_role": "serving", "target_role": "training",
               "source_roles": dict(src["roles"]), "source_width": 0,
               "target_width": 1, "source_roles_doc": src,
               "target_roles_doc": tgt,
               "resized": port.FENCES.index(fence) > 3}
        s.journal.begin(doc)
        if fence != "plan":
            s.journal.advance(doc, fence)
    outcomes = []
    for s, pkg in zip(sups, (port, ref)):
        again = pkg.FleetSupervisor(s.journal.root, executor=s.executor)
        outcomes.append(again.last_outcome)
        assert again.journal.pending() is None
    assert outcomes[0] == outcomes[1] == (
        "rolled_forward" if port.FENCES.index(fence) >= port.COMMIT_INDEX
        else "rolled_back")
    _same_state(*sups)
    assert sups[0].recover() is None


# -- the transaction, decide and the breaker ------------------------------

@pytest.mark.parametrize("fail_at", [None, "drain", "quiesce", "resize"])
def test_flip_transaction_equal(tmp_path, fail_at, monkeypatch):
    same_planner_constants(monkeypatch)
    sups = _pair(tmp_path, fail_at=fail_at)
    outs = []
    for s, pkg in zip(sups, (port, ref)):
        d = s.decide(_health(), now=0.0)
        outs.append(s.flip(d, now=0.0))
        if fail_at is None:
            # and back: to_serving skips the drain
            outs.append(s.flip(pkg.FlipDecision("to_serving", "e1", "x"),
                               now=1.0))
    assert outs[:len(outs) // 2] == outs[len(outs) // 2:]
    _same_state(*sups)
    calls = sups[0].executor.calls
    if fail_at is None:
        assert calls == [("drain", "e1"), ("quiesce", "e1"),
                         ("resize", 0, 1), ("activate", "e1", "training"),
                         ("quiesce", "e1"), ("resize", 1, 0),
                         ("activate", "e1", "serving")]
    else:
        assert calls[-1] == ("rollback", "e1") and \
            sups[0].roles_doc["training_width"] == 0


def test_decide_and_breaker_equal(tmp_path, monkeypatch):
    """A scripted run of health docs and clocks through both supervisors'
    ``tick``: hysteresis holds, pressure and idle flips, the cooldown,
    ``min_serving``, then a flip storm opening the breaker — every
    outcome, decision and document equal."""
    same_planner_constants(monkeypatch)
    roles = {"e0": "serving", "e1": "serving", "e2": "serving",
             "t0": "training"}
    sups = _pair(tmp_path, roles=roles, width=1, hysteresis_s=1.0,
                 cooldown_s=2.0, breaker_max_flips=2, breaker_window_s=30.0,
                 min_serving=1, min_speedup=-1.0)
    # 5 s blocks alternating idle and pressure (burn, then backlog),
    # ticks at seeded jittered times
    rng = np.random.default_rng(12)
    script = []
    t = 0.0
    while t < 60.0:
        t += float(rng.uniform(0.2, 0.6))
        block = int(t // 5.0) % 4
        script.append((t, (_health(), _health(burn=2.0), _health(),
                           _health(burn=0.1, backlog=9))[block]))
    results = []
    for s in sups:
        outs = []
        for now, h in script:
            d = s.decide(copy.deepcopy(h), now)
            outs.append(None if d is None else
                        (d.direction, d.engine, d.reason,
                         _scrub(d.price)))
            if d is not None:
                s.flip(d, now)
        results.append(outs)
    assert results[0] == results[1]
    assert any(results[0])
    _same_state(*sups)
    # the breaker opened and persisted in both roles docs
    assert sups[0].roles_doc["breaker_open_until"] > 0


def test_price_matches_the_reference_planner(tmp_path, monkeypatch):
    same_planner_constants(monkeypatch)
    sups = _pair(tmp_path)
    for w in (0, 2, 5):
        for s in sups:
            s.journal.save_roles({"roles": {"e0": "serving"},
                                  "training_width": w,
                                  "breaker_open_until": 0.0,
                                  "flips_committed": 0})
        for direction in ("to_training", "to_serving"):
            a, b = (s.price(direction) for s in sups)
            a, b = _scrub(a), _scrub(b)
            for side in ("source", "target"):
                if b.get(side) is None:
                    assert a.get(side) is None
                    continue
                assert a[side]["widths"] == b[side]["widths"]
                for k in ("predicted_step_s", "boundary_bytes"):
                    assert a[side][k] == pytest.approx(b[side][k],
                                                       rel=1e-12)
            assert a["approve"] == b["approve"]
            assert ("speedup" in a) == ("speedup" in b)
            if "speedup" in a:
                assert a["speedup"] == pytest.approx(b["speedup"],
                                                     rel=1e-12)


# -- the store-side executor over a port router and workers (the CPU) ----

ENG = dict(num_slots=2, max_length=64, page_size=16, prefix_cache=True,
           device="cpu")


@pytest.fixture(scope="module")
def model():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax_tiny_gpt() as jm:
        tm = torch_tiny_gpt(numpy_state(jm)).eval()
    yield tm
    torch.set_num_threads(threads)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).astype(np.int64) for n in lengths]


def test_live_flips_drain_evacuate_and_back(model, tmp_path, monkeypatch):
    """Headroom in the live plane's own health file flips worker 1 to
    training (drain, evacuate, resize 0 -> 1); ``min_serving`` holds the
    next flip; a backlog flips it back. Work dispatched to worker 1
    before its drain order lands is handed back by ``evacuate``. Every
    request done once, streams equal to one engine fed the router's
    params."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.observability import live
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import EngineWorker, Router

    tdir = tmp_path / "tele"
    tdir.mkdir()
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tdir))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    store = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=20.0)
    try:
        w0 = EngineWorker(model, store, name="w0", **ENG)
        w1 = EngineWorker(model, store, name="w1", **ENG)
        workers = [w0, w1]
        router = Router(store, queue_limit=32, seed=5)
        router._live_agg = live.LiveAggregator(window_s=600.0,
                                               health_interval_s=0.0)
        resolved = {}
        router.on_resolve = lambda req: resolved.__setitem__(
            req.rid, resolved.get(req.rid, 0) + 1)

        def pump():
            router.pump()
            for w in workers:
                w.poll_once()

        resized = []
        execu = port.StoreFleetExecutor(
            store, router=router,
            resize_fn=lambda s, t: resized.append((s, t)), pump=pump,
            poll_s=0.0)
        sup = port.FleetSupervisor(
            str(tmp_path / "journal"), executor=execu,
            # pressure is the backlog alone here (latency burn depends on
            # the machine's speed), and the wedged drain times out fast
            config=port.SupervisorConfig(hysteresis_s=0.05, cooldown_s=0.1,
                                         queue_high=2, high_burn=1e9,
                                         drain_timeout_s=0.3,
                                         min_speedup=-1.0),
            health_path=str(tdir / "fleet_health.json"),
            roles={"w0": "serving", "w1": "serving"}, training_width=0)
        prompts = _prompts(3, (20, 33, 17, 25, 21, 29))
        rids = [router.submit(p, slo="standard", max_new_tokens=6,
                              do_sample=(i % 2 == 0), temperature=0.7,
                              top_k=8) for i, p in enumerate(prompts)]
        while router.pending():
            pump()
        # headroom: the plane's health file shows the finished requests
        for _ in range(200):
            pump()
            h = port.read_health(sup.health_path)
            if sum(c["requests"] for c in h.get("classes", {}).values()) \
                    == len(rids):
                break
        assert sup._signals(h) == {"max_burn": 0.0, "admission_backlog": 0}
        # two requests land on w1 just before its drain: evacuate hands
        # them back (w1 is not polled while it drains)
        more = [router.submit(p, slo="standard", max_new_tokens=6)
                for p in prompts[:4]]
        router.pump()
        assert any(router._requests[r].engine == "w1" for r in more)
        execu._pump = router.pump      # w1 wedged during the drain
        outcome = None
        t0 = time.monotonic()
        while outcome is None:
            router.pump()
            w0.poll_once()
            outcome = sup.tick()
            assert time.monotonic() - t0 < 60
        execu._pump = pump
        assert outcome == "committed" and resized == [(0, 1)]
        assert sup.roles_doc["roles"]["w1"] == "training"
        assert router.counters["failover_resubmits"] >= 1
        while router.pending():
            pump()
        # min_serving = 1 holds the next flip while idle
        for _ in range(20):
            pump()
            assert sup.tick() is None
            time.sleep(0.01)
        # a backlog behind w0 flips w1 back
        burst = [router.submit(p, slo="standard", max_new_tokens=6)
                 for p in prompts + prompts]
        outcome = None
        t0 = time.monotonic()
        while outcome is None:
            pump()
            outcome = sup.tick()
            assert time.monotonic() - t0 < 60
        assert outcome == "committed" and resized == [(0, 1), (1, 0)]
        while router.pending():
            pump()
        all_rids = rids + more + burst
        assert set(resolved) == set(all_rids)
        assert set(resolved.values()) == {1}
        hist = sup.journal.history()
        assert [h["direction"] for h in hist] == ["to_training",
                                                  "to_serving"]
        # every flip's price recorded (a training side of width 0 prices
        # as idle: no step to predict)
        assert all(h["outcome"] == "committed" for h in hist)
        assert hist[0]["price"]["target"]["predicted_step_s"] > 0
        assert hist[1]["price"]["source"]["predicted_step_s"] > 0 and \
            hist[1]["price"]["target"] is None
        assert sup.journal.pending() is None
        single = DecodeEngine(model, EngineConfig(
            num_slots=4, max_length=64, page_size=16, prefix_cache=True),
            device="cpu")
        sr = [single.submit(router._requests[r].prompt,
                            router._requests[r].params) for r in all_rids]
        single.run()
        for r, s in zip(all_rids, sr):
            assert router.result(r).tolist() == single.result(s).tolist()
        router.shutdown()
        for w in workers:
            w.close()
    finally:
        store.close()


# -- SIGKILL at a fence: the scripted supervisor relaunched ---------------

HARNESS = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.environ["PT_REPO"])
    from paddle_tpu_torch.distributed.fleet.supervisor import (
        FleetSupervisor, FlipDecision, SupervisorConfig,
        _atomic_write_json, _read_json)

    state = sys.argv[1]
    train_path = os.path.join(state, "train_state.json")
    ledger_path = os.path.join(state, "ledger.jsonl")
    sup = FleetSupervisor(
        os.path.join(state, "journal"),
        config=SupervisorConfig(hysteresis_s=0.0, cooldown_s=0.0,
                                breaker_max_flips=100),
        roles={"e0": "serving", "e1": "serving"}, training_width=0)

    def width():
        return int(sup.roles_doc.get("training_width", 0))

    def ensure_width(target):
        for _ in range(4):
            w = width()
            if w == target:
                return
            d = "to_training" if target > w else "to_serving"
            sup.flip(FlipDecision(d, "e1", f"script->{target}"))
        raise SystemExit(f"ensure_width({target}) did not converge")

    def train(upto_steps):
        st = _read_json(train_path) or {"loss": 1.0, "hist": []}
        w = width()
        while len(st["hist"]) < upto_steps:
            step = len(st["hist"])
            st["loss"] = 0.9 * st["loss"] + 1.0 / (w + 1) + 0.001 * step
            st["hist"].append(st["loss"])
            _atomic_write_json(train_path, st)

    def serve(phase):
        have = set()
        if os.path.exists(ledger_path):
            with open(ledger_path) as f:
                have = {json.loads(ln)["rid"] for ln in f if ln.strip()}
        with open(ledger_path, "a") as f:
            for j in range(4):
                rid = f"p{phase}r{j}"
                if rid in have:
                    continue
                f.write(json.dumps({"rid": rid}) + "\\n")
                f.flush()

    PHASES = [(1, 3), (0, 6), (1, 9), (0, 12)]
    prog_path = os.path.join(state, "progress.json")
    start = int((_read_json(prog_path) or {}).get("next", 0))
    for i, (target_w, steps) in enumerate(PHASES):
        if i < start:
            continue
        ensure_width(target_w)
        train(steps)
        serve(i)
        _atomic_write_json(prog_path, {"next": i + 1})
    print(json.dumps({
        "hist": (_read_json(train_path) or {})["hist"],
        "flips": sup.roles_doc.get("flips_committed"),
        "pending": sup.journal.pending(),
    }))
""")


def _launch(state_dir, extra_env):
    env = {**os.environ, "PT_REPO": REPO}
    env.pop("PADDLE_CHAOS", None)
    env.pop("PADDLE_TPU_TELEMETRY_DIR", None)
    env.update(extra_env)
    return subprocess.run([sys.executable, "-c", HARNESS, str(state_dir)],
                          capture_output=True, text=True, env=env,
                          timeout=180)


def _finish(state_dir):
    proc = _launch(state_dir, {"PADDLE_RESTART_COUNT": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _rids(state_dir):
    with open(os.path.join(state_dir, "ledger.jsonl")) as f:
        return [json.loads(ln)["rid"] for ln in f if ln.strip()]


def _reference_hist():
    """The scripted trajectory's recurrence, computed here: the widths
    (1, 0, 1, 0) for 3 steps each."""
    loss, hist = 1.0, []
    for w, upto in ((1, 3), (0, 6), (1, 9), (0, 12)):
        while len(hist) < upto:
            loss = 0.9 * loss + 1.0 / (w + 1) + 0.001 * len(hist)
            hist.append(loss)
    return hist


def _kill_and_recover(tmp_path, fence, skip):
    killed = _launch(tmp_path, {
        "PADDLE_CHAOS": "1", "PADDLE_CHAOS_FLIP_MODE": "kill",
        "PADDLE_CHAOS_FLIP_AT": fence, "PADDLE_CHAOS_FLIP_SKIP": str(skip),
        "PADDLE_RESTART_COUNT": "0"})
    assert killed.returncode == -signal.SIGKILL, (
        fence, skip, killed.returncode, killed.stdout, killed.stderr)
    pending = json.loads(open(tmp_path / "journal" /
                              "flip_current.json").read())
    assert pending["fence"] == fence
    out = _finish(tmp_path)
    assert out["pending"] is None and out["flips"] == 4
    # JSON floats round-trip exactly: bit-equal to the unkilled recurrence
    assert out["hist"] == _reference_hist()
    rids = _rids(tmp_path)
    assert sorted(rids) == sorted(f"p{i}r{j}" for i in range(4)
                                  for j in range(4))
    assert len(rids) == len(set(rids))


@pytest.mark.parametrize("fence", ["resize", "commit"])
def test_sigkill_at_fence_recovers_bit_equal(tmp_path, fence):
    """One fence on each side of the durability point: ``resize`` rolls
    back, ``commit`` rolls forward."""
    _kill_and_recover(tmp_path, fence, 0)


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("fence,skip", [(f, 0) for f in port.FENCES]
                         + [("quiesce", 1), ("commit", 1)])
def test_sigkill_soak_every_fence(tmp_path, fence, skip):
    """The reference's all-fence soak (``tests/test_supervisor_chaos.py``,
    slow and chaos there too): every fence of the first flip, two of the
    second."""
    _kill_and_recover(tmp_path, fence, skip)
