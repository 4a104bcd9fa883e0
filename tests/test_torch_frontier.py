"""The port's federated front tier (``paddle_tpu_torch/serving/frontier.py``)
against the reference's, case for case with ``tests/test_frontier.py``.

The fast cases drive both packages' frontiers over their in-process stub
tiers (``serving.replay``: MemStore and fluid-rate StubWorkers on the
store key schema, one virtual clock), so every placement, quota decision
and resolution replays; each case runs the same scenario through both
and holds the port's placements, statuses, counters and fleet views
equal to the reference's. ``rendezvous_rank`` must rank exactly as the
reference's over keys, leaf sets and seeds. The last case is the
cross-topology gate on the port's real engines: the same submissions
through a one-leaf and a two-leaf tier give bit-equal token streams,
greedy and sampled, and the greedy ones equal the reference engine's on
the bridged weights.
"""
import json

import numpy as np
import pytest
import torch
from conftest import free_port

from paddle_tpu.observability import accounting as ref_acct
from paddle_tpu.serving import frontier as ref_frontier
from paddle_tpu.serving import replay as ref_replay
from paddle_tpu_torch.observability import accounting as _acct
from paddle_tpu_torch.serving import (FrontierRouter, Router,
                                      rendezvous_rank)
from paddle_tpu_torch.serving import frontier as port_frontier
from paddle_tpu_torch.serving import replay as port_replay
from paddle_tpu_torch.serving.frontier import _TokenBucket

from torch_port_utils import VOCAB, jax_tiny_gpt, numpy_state, torch_tiny_gpt

#: (frontier module, replay module) of each package
PKGS = {"ref": (ref_frontier, ref_replay),
        "port": (port_frontier, port_replay)}


def _both(scenario):
    """``scenario(frontier_mod, replay_mod)`` run in each package:
    {"ref": result, "port": result}."""
    return {name: scenario(f, r) for name, (f, r) in PKGS.items()}


# -- rendezvous hashing -------------------------------------------------------

def test_rendezvous_rank_is_deterministic_and_total():
    leaves = [f"leaf{i}" for i in range(5)]
    r1 = rendezvous_rank("acme", leaves)
    r2 = rendezvous_rank("acme", list(reversed(leaves)))
    assert sorted(r1) == sorted(leaves)
    assert r1 == r2  # order of the candidate list must not matter
    assert rendezvous_rank(b"acme", leaves) == r1  # str / bytes agree


@pytest.mark.parametrize("seed", [0, 1, 9, 1_000_003])
def test_rendezvous_rank_equals_reference(seed):
    rng = np.random.default_rng(seed)
    keys = ([f"tenant{i}" for i in range(40)] + ["-", "acme", "ünï",
                                                 "a|b", ""]
            + [rng.integers(0, 50_000, 16).astype(np.int64).tobytes()
               for _ in range(20)])
    leaf_sets = [["leaf0"], ["leaf0", "leaf1"],
                 [f"leaf{i}" for i in range(5)],
                 ["fed-a", "fed-b", "p57_b"], [f"l{i}" for i in range(8)]]
    for leaves in leaf_sets:
        for key in keys:
            assert rendezvous_rank(key, leaves, seed) == \
                ref_frontier.rendezvous_rank(key, leaves, seed), (key, leaves)


def test_rendezvous_minimal_disruption_on_leave():
    """Removing a leaf only moves the keys that ranked it first, each to
    its next ranked leaf."""
    leaves = [f"leaf{i}" for i in range(4)]
    keys = [f"tenant{i}" for i in range(200)]
    before = {k: rendezvous_rank(k, leaves)[0] for k in keys}
    remaining = [n for n in leaves if n != "leaf2"]
    moved = 0
    for k in keys:
        after = rendezvous_rank(k, remaining)[0]
        if before[k] == "leaf2":
            moved += 1
            assert after == rendezvous_rank(k, leaves)[1]
        else:
            assert after == before[k], k
    assert 0 < moved < len(keys)


def test_rendezvous_join_only_steals_top_ranked():
    leaves = ["leaf0", "leaf1"]
    keys = [f"t{i}" for i in range(200)]
    before = {k: rendezvous_rank(k, leaves)[0] for k in keys}
    after = {k: rendezvous_rank(k, leaves + ["leaf2"])[0] for k in keys}
    for k in keys:
        assert after[k] == before[k] or after[k] == "leaf2"


# -- frontier construction + sticky placement ---------------------------------

def _tier(replay_mod, n_leaves=2, engines=1, clock=None, **overrides):
    clock = clock or replay_mod.VirtualClock()
    frontier, workers, _ = replay_mod.build_stub_tier(
        n_leaves, engines, clock, **overrides)
    return frontier, workers, clock


def _drive(frontier, workers, clock, ticks=2000, dt=0.01):
    for _ in range(ticks):
        frontier.pump()
        for w in workers:
            w.poll()
        clock.advance(dt)
        if not frontier.pending():
            return
    raise AssertionError(f"undrained after {ticks} ticks: {frontier.stats()}")


def test_duplicate_leaf_namespaces_rejected():
    clock = port_replay.VirtualClock()
    store = port_replay.MemStore()
    leaves = [Router(store, namespace="same", dataplane="store",
                     clock=clock) for _ in range(2)]
    with pytest.raises(ValueError, match="distinct"):
        FrontierRouter(leaves)
    with pytest.raises(ValueError, match="at least one leaf"):
        FrontierRouter([])


def test_sticky_mapping_and_label_normalization():
    """A tenant maps to one leaf, and every raw spelling of its label maps
    with it; the leaves equal the reference's."""
    def scenario(_, rp):
        frontier, workers, clock = _tier(rp, n_leaves=3)
        prompt = np.arange(24, dtype=np.int64)
        gids = [frontier.submit(prompt, tenant=t, max_new_tokens=4)
                for t in ("acme", " acme ", "acme", "\tacme\n")]
        other = [frontier.submit(prompt, tenant="zebra-corp",
                                 max_new_tokens=4) for _ in range(3)]
        homes = [frontier.leaf_of(g) for g in gids + other]
        _drive(frontier, workers, clock)
        return homes, frontier.stats()["quota_shed"]

    got = _both(scenario)
    homes, shed = got["port"]
    assert len(set(homes[:4])) == 1 and len(set(homes[4:])) == 1
    assert shed == 0
    assert got["port"] == got["ref"]


def test_untagged_traffic_hashes_on_prompt_prefix():
    """Untagged requests pin by their first prompt page."""
    def scenario(_, rp):
        frontier, workers, clock = _tier(rp, n_leaves=3)
        page = np.arange(16, dtype=np.int64)
        gids = [frontier.submit(np.concatenate(
            [page, np.full(8, 50 + i, dtype=np.int64)]), max_new_tokens=4)
            for i in range(6)]
        gids.append(frontier.submit(np.arange(100, 124, dtype=np.int64),
                                    max_new_tokens=4))
        homes = [frontier.leaf_of(g) for g in gids]
        _drive(frontier, workers, clock)
        return homes

    got = _both(scenario)
    assert len(set(got["port"][:6])) == 1
    assert got["port"] == got["ref"]


# -- token-bucket quota -------------------------------------------------------

def test_token_bucket_burst_and_refill_edges():
    b = _TokenBucket(rate=100.0, burst=200.0, now=0.0)
    assert b.take(200.0, 0.0)          # exactly the burst: admitted
    assert not b.take(1.0, 0.0)        # empty
    assert not b.take(60.0, 0.5)       # refilled 50 < 60 (no debit)
    assert b.take(50.0, 0.5)           # ...but exactly 50 clears
    b2 = _TokenBucket(rate=100.0, burst=200.0, now=0.0)
    assert b2.take(200.0, 0.0)
    assert b2.take(100.0, 1.0)         # 1 s refill = 100 tokens
    assert not b2.take(1.0, 1.0)
    assert _TokenBucket(rate=100.0, burst=0.0, now=0.0).burst == 200.0
    b4 = _TokenBucket(rate=100.0, burst=150.0, now=0.0)
    assert b4.take(150.0, 0.0)
    assert not b4.take(151.0, 100.0)   # a long idle still caps at burst
    assert b4.take(150.0, 100.0)


def test_quota_sheds_attributed_and_refill_admits():
    def scenario(_, rp):
        clock = rp.VirtualClock()
        frontier, workers, _ = _tier(
            rp, clock=clock, tenant_quotas={"limited": (100.0, 100.0)})
        prompt = np.arange(46, dtype=np.int64)  # cost 46 + 4 = 50
        gids = [frontier.submit(prompt, tenant="limited", max_new_tokens=4)
                for _ in range(3)]
        with pytest.raises(RuntimeError, match="quota"):
            frontier.result(gids[2])
        clock.advance(0.5)  # 50 tokens refill: one more admits
        gids.append(frontier.submit(prompt, tenant="limited",
                                    max_new_tokens=4))
        return ([frontier.status(g) for g in gids],
                frontier.counters["quota_shed"])

    got = _both(scenario)
    assert got["port"] == (["queued", "queued", "shed", "queued"], 1)
    assert got["port"] == got["ref"]


def test_quota_shed_charged_to_tenant_and_never_reaches_a_leaf(
        tmp_path, monkeypatch):
    """With accounting on, a quota shed lands in the tenant's ledger row
    (``shed_requests``) and in no leaf's counters; the reference's
    frontier books the same."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))

    def scenario(fm, rp):
        frontier, workers, clock = _tier(
            rp, tenant_quotas={"capped": (1.0, 1.0)})
        resolved = {}
        frontier.on_resolve = lambda gid, req: resolved.update(
            {gid: (req.status, req.shed_reason)})
        prompt = np.arange(20, dtype=np.int64)
        for i in range(4):
            frontier.submit(prompt, tenant=f"t{i}", max_new_tokens=4)
        frontier.submit(prompt, tenant="capped", max_new_tokens=4)
        _drive(frontier, workers, clock)
        view = frontier.fleet_view()
        row = frontier._acct.per_tenant().get("capped", {})
        return (resolved[4], [resolved[g] for g in range(4)],
                frontier.counters["quota_shed"], row.get("shed_requests"),
                sum(v["dispatched"] for v in view["leaves"].values()),
                view["quota"])

    got = _both(scenario)
    status, ok, quota_shed, charged, dispatched, quota = got["port"]
    assert status == ("shed", "quota") and ok == [("done", None)] * 4
    assert quota_shed == 1 and charged == 1 and dispatched == 4
    assert quota == {"tracked_buckets": 1, "throttled_total": 1}
    assert got["port"] == got["ref"]
    assert _acct.normalize_tenant(" capped ") == \
        ref_acct.normalize_tenant(" capped ") == "capped"


def test_untagged_never_drains_a_tagged_bucket():
    """Untagged traffic touches only the "-" bucket, and a raw-spelled
    label its normalized bucket."""
    def scenario(_, rp):
        f2, _, _ = _tier(rp, tenant_quotas={"abuser": (10.0, 10.0)})
        prompt = np.arange(20, dtype=np.int64)
        flood = [f2.status(f2.submit(prompt, max_new_tokens=4))
                 for _ in range(50)]
        ga = f2.submit(prompt[:6], tenant="  abuser ", max_new_tokens=4)
        gb = f2.submit(prompt[:6], tenant="abuser", max_new_tokens=4)
        return set(flood), f2.status(ga), f2.status(gb), set(f2._buckets)

    got = _both(scenario)
    assert got["port"] == ({"queued"}, "queued", "shed", {"abuser"})
    assert got["port"] == got["ref"]


def test_synchronous_leaf_shed_still_resolves_through_relay():
    """A leaf can shed a request inside submit (queue preemption), before
    the frontier maps its rid; the orphan buffer still delivers it, once."""
    def scenario(_, rp):
        frontier, workers, clock = _tier(rp, queue_limit=4)
        frontier.config.retain_results = False
        seen = []
        frontier.on_resolve = lambda gid, req: seen.append((gid, req.status))
        prompt = np.arange(30, dtype=np.int64)
        for _ in range(40):
            frontier.submit(prompt, slo="batch", max_new_tokens=4)
        _drive(frontier, workers, clock)
        return seen

    got = _both(scenario)
    seen = got["port"]
    assert len(seen) == 40 and len({g for g, _ in seen}) == 40
    assert {s for _, s in seen} == {"done", "shed"}
    assert seen == got["ref"]


# -- hot-tenant spread --------------------------------------------------------

def test_hot_tenant_spreads_over_top_ranked_leaves():
    def scenario(fm, rp):
        frontier, workers, clock = _tier(rp, n_leaves=4)
        prompt = np.arange(24, dtype=np.int64)
        cold = [frontier.leaf_of(frontier.submit(
            prompt, tenant="whale", max_new_tokens=4)) for _ in range(6)]
        frontier.note_hot_tenants(["whale"])
        hot = [frontier.leaf_of(frontier.submit(
            prompt, tenant="whale", max_new_tokens=4)) for _ in range(40)]
        ranked = fm.rendezvous_rank("whale", frontier._names,
                                    frontier.config.seed)
        _drive(frontier, workers, clock)
        return (cold, hot, ranked[:max(2, frontier.config.hot_tenant_spread)],
                frontier.counters["hot_spread_placements"])

    got = _both(scenario)
    cold, hot, spread, n = got["port"]
    assert len(set(cold)) == 1
    assert set(hot) <= set(spread) and len(set(hot)) > 1 and n > 0
    assert got["port"] == got["ref"]


def test_hot_tenant_set_refreshes_from_the_sketch():
    """Without the live plane the submit-fed sketch marks a tenant past
    ``hot_tenant_share`` hot at the rebalance cadence, as the
    reference's does."""
    def scenario(_, rp):
        frontier, workers, clock = _tier(rp, n_leaves=3,
                                         rebalance_interval_s=0.05)
        prompt = np.arange(24, dtype=np.int64)
        for i in range(30):
            frontier.submit(prompt, tenant="whale" if i % 3 else f"c{i}",
                            max_new_tokens=4)
        _drive(frontier, workers, clock)
        return sorted(frontier._hot), dict(frontier.counters)

    got = _both(scenario)
    assert got["port"][0] == ["whale"]
    assert got["port"][1]["rebalances"] == 1
    assert got["port"] == got["ref"]


# -- fleet view + aggregation -------------------------------------------------

def test_fleet_view_merges_leaf_state():
    def scenario(_, rp):
        frontier, workers, clock = _tier(rp, n_leaves=2, engines=2)
        prompt = np.arange(24, dtype=np.int64)
        for i in range(12):
            frontier.submit(prompt, tenant=f"t{i % 4}", max_new_tokens=4,
                            slo="interactive" if i % 2 else "standard")
        view = frontier.fleet_view()
        _drive(frontier, workers, clock)
        st = frontier.stats()
        return view, {k: v for k, v in st.items() if k != "per_leaf"}, \
            sorted(st["per_leaf"])

    got = _both(scenario)
    view, st, per_leaf = got["port"]
    assert set(view["leaves"]) == {"leaf0", "leaf1"} == set(per_leaf)
    assert view["queue_depth"] == sum(
        v["queue_depth"] for v in view["leaves"].values())
    for c in ("interactive", "standard", "batch"):
        assert view["admission"][c] == sum(
            v["admission"][c] for v in view["leaves"].values())
    assert view["quota"]["throttled_total"] == 0
    assert st["placed"] == 12 and st["leaves"]["done"] == 12
    assert got["port"] == got["ref"]


def test_live_health_doc_carries_frontier_block(tmp_path, monkeypatch):
    """With the live plane on, one shared aggregator carries the merged
    supervisor-visible queues and the per-leaf frontier block into
    fleet_health.json."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    frontier, workers, clock = _tier(port_replay, n_leaves=2, engines=1)
    prompt = np.arange(24, dtype=np.int64)
    for _ in range(8):
        frontier.submit(prompt, tenant="acme", max_new_tokens=4)
    _drive(frontier, workers, clock)
    agg = frontier._live_agg
    assert agg is not None, "the frontier owns the shared aggregator"
    assert all(leaf._live_agg is agg for leaf in frontier._leaves.values())
    agg.write_health()
    doc = json.loads((tmp_path / "fleet_health.json").read_text())
    assert set(doc["frontier"]["leaves"]) == {"leaf0", "leaf1"}
    assert doc["frontier"] == json.loads(json.dumps(frontier.fleet_view()))
    assert "admission" in doc["queues"]


# -- abusive-tenant isolation (stub tier, virtual time) -----------------------

def test_abusive_tenant_isolation_under_quota():
    """With the abuser under a token bucket the victims' p95 admission
    latency stays near the no-abuser baseline and the abuser's sheds are
    quota-attributed; the abused run's summary equals the reference's."""
    def specs(rp):
        base = rp.make_spec("mixed", seed=5, rate_rps=4000.0)
        abuse = rp.make_spec("mixed", seed=5, rate_rps=4000.0,
                             abuse_rps=4000.0)
        abuse["abuse"]["start_s"] = 0.2
        return base, abuse

    kw = dict(n_leaves=2, engines_per_leaf=2, tokens_per_s=200_000.0,
              queue_limit=2048)
    quota = {"abuser": (500.0, 1000.0)}
    base_spec, abuse_spec = specs(port_replay)
    base = port_replay.run_stub_replay(base_spec, 6000, **kw)
    abuse = port_replay.run_stub_replay(abuse_spec, 9000,
                                        tenant_quotas=quota, **kw)
    ab = abuse["tenants"]["abuser"]
    assert ab.get("shed_quota", 0) > ab.get("done", 0) > 0
    assert abuse["frontier"]["quota_shed"] == sum(
        r.get("shed_quota", 0) for r in abuse["tenants"].values())
    v0 = base["tenants"]["t000"]["admission_p95_s"]
    v1 = abuse["tenants"]["t000"]["admission_p95_s"]
    assert v1 <= v0 * 1.25 + 1e-3, (v0, v1)
    want = ref_replay.run_stub_replay(specs(ref_replay)[1], 9000,
                                      tenant_quotas=quota, **kw)
    drop = ("wall_s", "throughput_rps", "dispatch_rps")
    assert {k: v for k, v in abuse.items() if k not in drop} == {
        k: v for k, v in want.items() if k not in drop}


# -- determinism --------------------------------------------------------------

def test_same_seed_same_ledger_digest():
    kw = dict(n_leaves=2, engines_per_leaf=2, tokens_per_s=300_000.0)
    spec = port_replay.make_spec("mixed", seed=13, rate_rps=5000.0)
    a = port_replay.run_stub_replay(spec, 4000, **kw)
    b = port_replay.run_stub_replay(spec, 4000, **kw)
    assert a["digest"] == b["digest"] and a["classes"] == b["classes"]
    c = port_replay.run_stub_replay(
        port_replay.make_spec("mixed", seed=14, rate_rps=5000.0), 4000, **kw)
    assert c["digest"] != a["digest"], "different seed, different run"
    ref = ref_replay.run_stub_replay(
        ref_replay.make_spec("mixed", seed=13, rate_rps=5000.0), 4000, **kw)
    assert a["digest"] == ref["digest"]


# -- real engines: 1-leaf vs 2-leaf bit-equality ------------------------------

ENG = dict(num_slots=2, max_length=64, page_size=16, prefix_cache=True,
           device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny CPU engines (six test processes
    share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    with jax_tiny_gpt() as jm:
        yield jm, torch_tiny_gpt(numpy_state(jm)).eval()


@pytest.fixture()
def store():
    from paddle_tpu_torch.runtime import TCPStore

    s = TCPStore(host="127.0.0.1", port=free_port(), is_master=True,
                 timeout=20.0)
    yield s
    s.close()


def _requests():
    rng = np.random.default_rng(3)
    shared = rng.integers(1, VOCAB, size=18).astype(np.int64)
    reqs = []
    for i in range(8):
        if i % 2:
            prompt = np.concatenate(
                [shared, rng.integers(1, VOCAB, size=5 + i).astype(np.int64)])
        else:
            prompt = rng.integers(1, VOCAB, size=16 + i).astype(np.int64)
        reqs.append((prompt, f"tenant{i % 3}",
                     dict(max_new_tokens=8, do_sample=(i % 2 == 0),
                          temperature=0.8, top_k=8)))
    return reqs


def test_greedy_streams_bit_equal_one_leaf_vs_two(models, store):
    """The cross-topology gate: the same submissions into a one-leaf and
    a two-leaf tier give bit-equal tokens, greedy and sampled alike
    (gid-derived seeds make placement invisible); each request lands on
    its tenant's first rendezvous leaf; the greedy streams equal the
    reference engine's."""
    from paddle_tpu.inference import engine as ref_engine
    from paddle_tpu_torch.serving import EngineWorker

    jm, tm = models
    reqs = _requests()

    def run_tier(namespaces):
        workers, leaves = [], []
        for ns in namespaces:
            leaves.append(Router(store, namespace=ns, queue_limit=32,
                                 dataplane="store"))
            for j in range(2 if len(namespaces) == 1 else 1):
                workers.append(EngineWorker(tm, store, namespace=ns,
                                            name=f"{ns}-e{j}", **ENG))
        frontier = FrontierRouter(leaves, seed=9)
        gids = [frontier.submit(p, tenant=t, **kw) for p, t, kw in reqs]
        for _ in range(800):
            frontier.pump()
            for w in workers:
                w.poll_once()
            if not frontier.pending():
                break
        else:
            raise AssertionError(f"undrained: {frontier.stats()}")
        for gid, (_, tenant, _) in zip(gids, reqs):
            assert frontier.leaf_of(gid) == rendezvous_rank(
                tenant, namespaces, 9)[0]
        out = [frontier.result(g).tolist() for g in gids]
        for w in workers:
            w.close()
        return out

    one = run_tier(["fed-one"])
    two = run_tier(["fed-a", "fed-b"])
    assert one == two
    eng = ref_engine.DecodeEngine(jm, attn_kernel="einsum", num_slots=4,
                                  max_length=64, page_size=16,
                                  prefix_cache=True)
    greedy = [i for i, (_, _, kw) in enumerate(reqs) if not kw["do_sample"]]
    rids = [eng.submit(reqs[i][0], max_new_tokens=8) for i in greedy]
    eng.run()
    assert [one[i] for i in greedy] == [
        np.asarray(eng.result(r)).tolist() for r in rids]
