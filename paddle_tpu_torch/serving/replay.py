"""Deterministic workload replay for the serving control plane
(counterpart of ``paddle_tpu/serving/replay.py``).

A benchmark of the federated router tier cannot lean on wall-clock load
generators: arrival jitter would make every run a new workload, and real
decode cost caps a run at thousands of requests. This module replays
millions of synthetic requests through the REAL control plane (the
``FrontierRouter`` quota / hashing path, the ``Router`` admission /
placement / harvest loop, the store key schema of serving/protocol.py)
against either real engine workers or in-process **stub workers** that
model service as a fluid token rate, so the tier's own dispatch
throughput is what gets measured.

- **Deterministic arrivals.** ``arrivals(spec)`` yields an endless
  time-ordered event stream (arrival time, tenant, SLO class, prompt,
  decode budget) from ``numpy.random.default_rng`` seeded per mix
  component: same spec, same seed, same stream, on any host, and event
  for event the reference's. The mix composes ``steady`` Poisson floors,
  ``diurnal`` sinusoid-modulated bursts, ``agentic`` multi-turn sessions
  whose prompts grow a shared prefix, ``longdoc`` prefill-heavy
  outliers, and ``abuse``: one tenant flooding at a configured rate and
  window.
- **Virtual time.** The driver advances a ``VirtualClock`` injected into
  the frontier, every leaf router and every stub worker, so deadline
  sheds, quota refills, liveness grace and service completion are pure
  functions of the workload. Two replays of one seed produce identical
  admission / shed / completion ledgers, fingerprinted by a running
  sha256 over every resolution (``ReplayLedger.digest``).
- **Leaf-stub mode.** ``StubWorker`` registers through the store like an
  ``EngineWorker`` (count key, registration record, occupancy beats with
  monotone ``beat`` / ``acked_seq`` / ``done_count``) and serves the seq
  stream at ``tokens_per_s``, writing done keys the router harvests: the
  store dataplane's contract at no decode cost. ``MemStore`` keeps the
  store in-process with the surface of ``runtime.TCPStore``; consumed
  dispatch records and harvested done keys are reaped so a
  million-request run stays memory-bounded.

For wall-clock scaling runs each leaf runs in its own OS process:
``run_leaf_shard`` replays the SAME seeded stream, keeps only the events
rendezvous hashing assigns to its leaf (the sticky mapping the frontier
applies) and stamps the same gid-derived seeds, so N shard processes
together serve exactly the workload one leaf serves alone, and their
summed dispatched-requests/s is comparable.
``python -m paddle_tpu_torch.serving.replay`` is the shard entry point.
No torch here: the control plane runs on the host.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..observability import accounting as _acct
from .frontier import FrontierConfig, FrontierRouter, rendezvous_rank
from .protocol import (SLO_CLASSES, deadline_guard, k_count, k_done,
                       k_engine, k_occ, k_req, pack, unpack)
from .router import Router, RouterConfig, RouterRequest

__all__ = ["MemStore", "StubWorker", "VirtualClock", "ReplayLedger",
           "arrivals", "make_spec", "build_stub_tier", "replay",
           "run_stub_replay", "run_leaf_shard"]

#: stub vocabulary for generated prompts / result tokens
_VOCAB = 50_000


class VirtualClock:
    """The replay time source: starts at 0, advances only when the
    driver says so. Injected into frontier, leaves, and stub workers so
    every timer in the tier ticks off the same deterministic axis."""

    __slots__ = ("now",)

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


class MemStore:
    """In-process dict with the TCPStore client surface the serving
    plane uses (set/get/add/check/wait/delete_key). Single-threaded by
    design — the replay driver interleaves router pumps and worker
    polls itself."""

    def __init__(self):
        self._d: Dict[str, object] = {}

    def set(self, key: str, value):
        self._d[key] = value

    def get(self, key: str):
        return self._d[key]

    def add(self, key: str, amount: int) -> int:
        value = int(self._d.get(key, 0)) + int(amount)
        self._d[key] = value
        return value

    def check(self, keys) -> bool:
        if isinstance(keys, (list, tuple)):
            return all(k in self._d for k in keys)
        return keys in self._d

    def wait(self, keys, timeout=None):
        if not self.check(keys):
            raise RuntimeError(f"MemStore.wait: keys absent: {keys!r}")

    def delete_key(self, key: str) -> bool:
        return self._d.pop(key, None) is not None

    def __len__(self) -> int:
        return len(self._d)


class StubWorker:
    """A fluid-rate engine stand-in on the store dataplane.

    Registers exactly like ``EngineWorker`` (serving/worker.py): bumps
    the namespace count key, writes its registration record, then per
    ``poll()`` consumes the router's seq stream, "serves" queued
    requests at ``tokens_per_s`` of virtual time, writes each finished
    request's done key BEFORE the occupancy beat that acks it (the
    store-ordering contract failover depends on), and publishes a beat
    with the fields the router's liveness/harvest logic reads. Consumed
    dispatch keys are deleted so the store stays bounded."""

    def __init__(self, store, namespace: str, *, clock: VirtualClock,
                 name: Optional[str] = None, num_slots: int = 64,
                 tokens_per_s: float = 250_000.0, page_size: int = 16,
                 max_length: int = 4096):
        self._store = store
        self._ns = namespace
        self._clock = clock
        self.tokens_per_s = float(tokens_per_s)
        with deadline_guard("register engine"):
            self.index = int(store.add(k_count(namespace), 1)) - 1
        self.name = name or f"stub{self.index}"
        record = {"name": self.name, "index": self.index,
                  "num_slots": num_slots, "max_length": max_length,
                  "page_size": page_size, "buckets": [max_length],
                  "pid": 0, "addr": None, "role": "unified",
                  "kv_wire": "raw"}
        with deadline_guard("register engine"):
            store.set(k_engine(namespace, self.index), pack(record))
        self._next_seq = 0
        self._beat = 0
        self._done_count = 0
        self._budget = 0.0
        self._t = clock()
        self._q: deque = deque()  # (rid, cost, params) FIFO service line
        self._outstanding = 0

    @staticmethod
    def _result_tokens(params: dict) -> List[int]:
        """Deterministic pseudo-decode: a short stream derived from the
        request's (router/frontier-assigned) sampling seed, so identical
        placements yield identical tokens on any stub."""
        seed = int(params.get("seed") or 0)
        n = min(4, int(params.get("max_new_tokens", 1)))
        return [(seed * 7919 + i * 104729) % _VOCAB for i in range(n)]

    def poll(self) -> int:
        """One worker turn: drain dispatches, serve by rate, publish.
        Returns how many requests finished this turn."""
        now = self._clock()
        finished = 0
        with deadline_guard("stub worker pump"):
            while True:
                key = k_req(self._ns, self.name, self._next_seq)
                if not self._store.check(key):
                    break
                rec = unpack(self._store.get(key))
                self._store.delete_key(key)
                self._next_seq += 1
                cost = len(rec["prompt"]) + int(
                    rec["params"].get("max_new_tokens", 1))
                self._q.append((rec["rid"], cost, rec["params"]))
                self._outstanding += cost
            if now > self._t:
                # fluid server: capacity accrues with virtual time, capped
                # at one second of rate so idle gaps don't bank a mega-burst
                self._budget = min(self._budget
                                   + (now - self._t) * self.tokens_per_s,
                                   self.tokens_per_s)
                self._t = now
            while self._q and self._q[0][1] <= self._budget:
                rid, cost, params = self._q.popleft()
                self._budget -= cost
                self._outstanding -= cost
                self._store.set(
                    k_done(self._ns, rid),
                    pack({"rid": rid,
                          "tokens": self._result_tokens(params)}))
                self._done_count += 1
                finished += 1
            self._beat += 1
            self._store.set(k_occ(self._ns, self.name), pack({
                "beat": self._beat, "acked_seq": self._next_seq,
                "done_count": self._done_count, "name": self.name,
                "role": "unified", "prefill_queue": 0, "draining": False,
                "drained": False,
                "outstanding_tokens": int(self._outstanding)}))
        return finished


# -- workload grammar --------------------------------------------------------

def make_spec(profile: str = "mixed", seed: int = 0,
              rate_rps: float = 20_000.0, abuse_rps: float = 0.0,
              abuse_tenant: str = "abuser", tenants: int = 24,
              zipf_s: float = 1.2, tagged_share: float = 0.8) -> dict:
    """Canonical specs for the named profiles (``steady``, ``mixed``).
    ``rate_rps`` is the total virtual arrival rate across the mix;
    ``abuse_rps`` > 0 adds a flooding tenant on top of it."""
    if profile == "steady":
        mix = [{"kind": "steady", "share": 1.0}]
    elif profile == "mixed":
        mix = [
            {"kind": "steady", "share": 0.35},
            {"kind": "diurnal", "share": 0.30, "amp": 0.6,
             "period_s": 20.0},
            {"kind": "agentic", "share": 0.25, "turns": 6,
             "think_s": 0.5, "turn_tokens": 12},
            {"kind": "longdoc", "share": 0.10, "doc_tokens": 384},
        ]
    else:
        raise ValueError(f"unknown profile {profile!r}")
    spec = {"seed": int(seed), "rate_rps": float(rate_rps), "mix": mix,
            "tenants": {"n": int(tenants), "zipf_s": float(zipf_s),
                        "tagged_share": float(tagged_share)},
            "slo_mix": {"interactive": 0.5, "standard": 0.35,
                        "batch": 0.15},
            "prompt_tokens": [8, 48], "max_new_tokens": [8, 32]}
    if abuse_rps > 0:
        spec["abuse"] = {"tenant": abuse_tenant, "rate_rps": float(
            abuse_rps), "start_s": 2.0, "prompt_tokens": 32,
            "max_new_tokens": 32, "slo": "interactive"}
    return spec


class _TenantPicker:
    """Zipf-ranked tenant draw: rank-i tenant has weight (i+1)^-s; a
    ``1 - tagged_share`` slice of traffic stays untagged (None). The
    CDF is precomputed — one uniform + one searchsorted per draw, not a
    weighted choice() (this runs a million times per bench)."""

    def __init__(self, cfg: dict, rng):
        n = int(cfg.get("n", 16))
        s = float(cfg.get("zipf_s", 1.2))
        w = np.arange(1, n + 1, dtype=np.float64) ** -s
        self._cdf = np.cumsum(w / w.sum())
        self._names = [f"t{i:03d}" for i in range(n)]
        self._tagged = float(cfg.get("tagged_share", 0.8))
        self._rng = rng

    def pick(self) -> Optional[str]:
        if self._rng.random() >= self._tagged:
            return None
        return self._names[int(np.searchsorted(self._cdf,
                                               self._rng.random()))]


class _SloPicker:
    """Weighted SLO-class draw off a precomputed CDF (sorted class
    order, so the draw sequence is spec-deterministic)."""

    def __init__(self, slo_mix: dict, rng):
        self._classes = sorted(slo_mix)
        w = np.asarray([slo_mix[c] for c in self._classes],
                       dtype=np.float64)
        self._cdf = np.cumsum(w / w.sum())
        self._rng = rng

    def pick(self) -> str:
        return self._classes[int(np.searchsorted(self._cdf,
                                                 self._rng.random()))]


def arrivals(spec: dict) -> Iterator[dict]:
    """Endless time-ordered event stream for ``spec``. Each event:
    ``{"t", "tenant", "slo", "prompt", "max_new_tokens"}``. Every mix
    component owns an independent, component-index-seeded generator, so
    the merged stream is deterministic no matter how far it is drawn.
    """
    seed = int(spec.get("seed", 0))
    total_rate = float(spec.get("rate_rps", 1000.0))
    lo_p, hi_p = spec.get("prompt_tokens", [8, 48])
    lo_m, hi_m = spec.get("max_new_tokens", [8, 32])
    slo_mix = spec.get("slo_mix", {"standard": 1.0})
    tcfg = spec.get("tenants", {})

    def steady_like(comp: dict, idx: int) -> Iterator[dict]:
        rng = np.random.default_rng([seed, idx])
        picker = _TenantPicker(tcfg, rng)
        slos = _SloPicker(slo_mix, rng)
        rate = total_rate * float(comp.get("share", 1.0))
        kind = comp["kind"]
        amp = float(comp.get("amp", 0.0))
        period = float(comp.get("period_s", 20.0))
        doc = int(comp.get("doc_tokens", 384))
        peak = rate * (1.0 + abs(amp)) if kind == "diurnal" else rate
        t = 0.0
        while True:
            t += rng.exponential(1.0 / peak)
            if kind == "diurnal":
                # thinning: accept against the sinusoid-modulated rate
                inst = rate * (1.0 + amp * np.sin(
                    2.0 * np.pi * t / period))
                if rng.random() * peak > max(inst, 0.0):
                    continue
            if kind == "longdoc":
                plen = int(rng.integers(doc // 2, doc + 1))
                mnew = int(rng.integers(4, 12))
            else:
                plen = int(rng.integers(lo_p, hi_p + 1))
                mnew = int(rng.integers(lo_m, hi_m + 1))
            yield {"t": t, "tenant": picker.pick(),
                   "slo": slos.pick(),
                   "prompt": rng.integers(0, _VOCAB, size=plen,
                                          dtype=np.int64),
                   "max_new_tokens": mnew}

    def agentic(comp: dict, idx: int) -> Iterator[dict]:
        """Multi-turn sessions: each turn's prompt is the session's
        growing prefix plus fresh tokens — the affinity-cache traffic
        shape. Session starts are Poisson; turns trail by think time."""
        rng = np.random.default_rng([seed, idx])
        picker = _TenantPicker(tcfg, rng)
        rate = total_rate * float(comp.get("share", 1.0))
        turns_max = int(comp.get("turns", 6))
        think = float(comp.get("think_s", 0.5))
        per_turn = int(comp.get("turn_tokens", 12))
        import heapq as _hq
        t = rng.exponential(1.0 / rate)
        pend: list = []  # (turn_t, tiebreak, remaining, prefix, tenant)
        tie = 0
        while True:
            while pend and pend[0][0] <= t:
                turn_t, _, remaining, prefix, tenant = _hq.heappop(pend)
                prompt = np.concatenate(
                    [prefix, rng.integers(0, _VOCAB, size=per_turn,
                                          dtype=np.int64)])
                mnew = int(rng.integers(lo_m, hi_m + 1))
                yield {"t": turn_t, "tenant": tenant,
                       "slo": "interactive", "prompt": prompt,
                       "max_new_tokens": mnew}
                if remaining > 1:
                    tie += 1
                    _hq.heappush(pend, (
                        turn_t + rng.exponential(think), tie,
                        remaining - 1, prompt, tenant))
            tie += 1
            _hq.heappush(pend, (
                t, tie, int(rng.integers(2, turns_max + 1)),
                rng.integers(0, _VOCAB, size=per_turn, dtype=np.int64),
                picker.pick()))
            t += rng.exponential(1.0 / rate)

    def abuse(comp: dict, idx: int) -> Iterator[dict]:
        rng = np.random.default_rng([seed, idx])
        rate = float(comp["rate_rps"])
        t = float(comp.get("start_s", 0.0))
        plen = int(comp.get("prompt_tokens", 32))
        mnew = int(comp.get("max_new_tokens", 32))
        stop = float(comp.get("end_s", float("inf")))
        while t < stop:
            t += rng.exponential(1.0 / rate)
            yield {"t": t, "tenant": comp.get("tenant", "abuser"),
                   "slo": comp.get("slo", "interactive"),
                   "prompt": rng.integers(0, _VOCAB, size=plen,
                                          dtype=np.int64),
                   "max_new_tokens": mnew}

    streams: List[Iterator[dict]] = []
    for i, comp in enumerate(spec.get("mix", [])):
        if comp["kind"] == "agentic":
            streams.append(agentic(comp, i))
        else:
            streams.append(steady_like(comp, i))
    if spec.get("abuse"):
        streams.append(abuse(spec["abuse"], len(streams)))

    import heapq as _hq
    heads = []
    for i, it in enumerate(streams):
        ev = next(it, None)
        if ev is not None:
            heads.append((ev["t"], i, ev))
    _hq.heapify(heads)
    while heads:
        t, i, ev = _hq.heappop(heads)
        yield ev
        nxt = next(streams[i], None)
        if nxt is not None:  # finite components (abuse windows) drain out
            _hq.heappush(heads, (nxt["t"], i, nxt))


# -- ledger ------------------------------------------------------------------

class _Reservoir:
    """Deterministic stride-decimated sample for quantiles: keeps every
    2^k-th value once full, so two identical runs keep identical
    samples (no RNG, no wall clock)."""

    __slots__ = ("cap", "stride", "seen", "vals")

    def __init__(self, cap: int = 65536):
        self.cap = cap
        self.stride = 1
        self.seen = 0
        self.vals: List[float] = []

    def add(self, v: float):
        if self.seen % self.stride == 0:
            if len(self.vals) >= self.cap:
                self.vals = self.vals[::2]
                self.stride *= 2
            if self.seen % self.stride == 0:
                self.vals.append(v)
        self.seen += 1

    def quantile(self, q: float) -> float:
        if not self.vals:
            return 0.0
        s = sorted(self.vals)
        return s[min(len(s) - 1, int(q * len(s)))]


class ReplayLedger:
    """Per-(tenant, slo) outcome counts, admission-latency samples, and
    the run fingerprint: a running sha256 over every resolution in
    order (gid, status, shed reason, result tokens). Same seed + same
    topology => same digest, byte for byte."""

    def __init__(self):
        self.rows: Dict[Tuple[str, str], Dict[str, int]] = {}
        self.adm_slo: Dict[str, _Reservoir] = {}
        self.adm_tenant: Dict[str, _Reservoir] = {}
        self.resolved = 0
        self._h = hashlib.sha256()

    def resolve(self, gid: int, req: RouterRequest):
        row = self.rows.setdefault((req.tenant, req.slo), {
            "done": 0, "failed": 0, "shed_quota": 0, "shed_queue_full": 0,
            "shed_deadline": 0})
        if req.status == "shed":
            row[f"shed_{req.shed_reason}"] = row.get(
                f"shed_{req.shed_reason}", 0) + 1
        else:
            row[req.status] = row.get(req.status, 0) + 1
        toks = b""
        if req.status == "done" and req.tokens is not None:
            toks = np.asarray(req.tokens, dtype=np.int64).tobytes()
        self._h.update(b"%d|%s|%s|" % (gid, req.status.encode(),
                                       (req.shed_reason or "").encode()))
        self._h.update(toks)
        if req.dispatch_t is not None:
            adm = req.dispatch_t - req.submit_t
            self.adm_slo.setdefault(req.slo, _Reservoir()).add(adm)
            self.adm_tenant.setdefault(req.tenant, _Reservoir()).add(adm)
        self.resolved += 1

    @property
    def digest(self) -> str:
        return self._h.hexdigest()

    def summary(self) -> dict:
        by_class: Dict[str, dict] = {}
        for (tenant, slo), row in self.rows.items():
            agg = by_class.setdefault(slo, {})
            for k, v in row.items():
                agg[k] = agg.get(k, 0) + v
        for slo, res in self.adm_slo.items():
            by_class.setdefault(slo, {})["admission_s"] = {
                "p50": res.quantile(0.50), "p95": res.quantile(0.95),
                "p99": res.quantile(0.99)}
        tenants = {}
        for (tenant, slo), row in sorted(self.rows.items()):
            cell = tenants.setdefault(tenant, {})
            for k, v in row.items():
                cell[k] = cell.get(k, 0) + v
        for tenant, res in self.adm_tenant.items():
            if tenant in tenants:
                tenants[tenant]["admission_p95_s"] = res.quantile(0.95)
        return {"resolved": self.resolved, "digest": self.digest,
                "classes": by_class, "tenants": tenants}


# -- drivers -----------------------------------------------------------------

def build_stub_tier(n_leaves: int, engines_per_leaf: int,
                    clock: VirtualClock, *, queue_limit: int = 4096,
                    tokens_per_s: float = 250_000.0, num_slots: int = 64,
                    dispatch_mode: str = "heap",
                    frontier_config: Optional[FrontierConfig] = None,
                    **frontier_overrides):
    """An in-process federated tier: ``n_leaves`` store-dataplane leaf
    routers (private MemStore each, results dropped through
    ``on_resolve``), ``engines_per_leaf`` stub workers per leaf with
    distinct names, one frontier on the shared virtual clock. Returns
    ``(frontier, workers, stores)``."""
    leaves, workers, stores = [], [], []
    for i in range(n_leaves):
        store = MemStore()
        ns = f"leaf{i}"
        leaves.append(Router(
            store, namespace=ns, dataplane="store",
            queue_limit=queue_limit, dispatch_mode=dispatch_mode,
            retain_results=False, harvest_budget=1024, clock=clock))
        for j in range(engines_per_leaf):
            workers.append(StubWorker(store, ns, clock=clock,
                                      name=f"l{i}e{j}",
                                      num_slots=num_slots,
                                      tokens_per_s=tokens_per_s))
        stores.append(store)
    frontier = FrontierRouter(leaves, config=frontier_config,
                              clock=clock, **frontier_overrides)
    return frontier, workers, stores


def _chain_reap(leaf: Router, inner, reap: list):
    """Wrap a leaf's resolution relay so every resolved rid queues its
    done key for deletion (after the frontier relay has run)."""
    ns, store = leaf.config.namespace, leaf._store

    def tap(req):
        if inner is not None:
            inner(req)
        reap.append((store, k_done(ns, req.rid)))
    return tap


def replay(tier, workers: List[StubWorker], clock: VirtualClock,
           spec: dict, n_requests: int, *, tick_s: float = 0.005,
           drain_ticks: int = 200_000,
           ledger: Optional[ReplayLedger] = None) -> dict:
    """Open-loop replay: inject ``spec``'s arrivals up to virtual now,
    pump the tier, poll the stubs, advance the clock — until
    ``n_requests`` have been submitted AND resolved. ``tier`` is a
    ``FrontierRouter`` or a bare leaf ``Router``; both expose the
    resolution tap the ledger hangs off. Returns the metrics block
    (wall seconds measure ONLY the replay loop — generation included,
    process startup excluded)."""
    led = ledger if ledger is not None else ReplayLedger()
    # reap queue: done keys become deletable only once the router has
    # resolved their rid — deleting earlier would strand inflight work
    reap: List[Tuple[object, str]] = []
    if isinstance(tier, FrontierRouter):
        tier.config.retain_results = False
        tier.on_resolve = led.resolve
        for leaf in tier._leaves.values():
            leaf.config.retain_results = False
            leaf.on_resolve = _chain_reap(leaf, leaf.on_resolve, reap)
    else:
        tier.config.retain_results = False

        def _tap(req, _ns=tier.config.namespace, _store=tier._store):
            led.resolve(req.rid, req)
            reap.append((_store, k_done(_ns, req.rid)))
        tier.on_resolve = _tap
    events = arrivals(spec)
    nxt = next(events)
    submitted = 0
    t0 = time.perf_counter()
    ticks = 0
    while led.resolved < submitted or submitted < n_requests:
        now = clock()
        while submitted < n_requests and nxt["t"] <= now:
            tier.submit(nxt["prompt"], slo=nxt["slo"],
                        tenant=nxt["tenant"],
                        max_new_tokens=nxt["max_new_tokens"])
            submitted += 1
            nxt = next(events)
        tier.pump()
        for w in workers:
            w.poll()
        clock.advance(tick_s)
        ticks += 1
        if len(reap) >= 4096:
            # reap resolved done keys so a million-request run keeps the
            # MemStores bounded (the router never re-reads a finished rid)
            with deadline_guard("reap done keys"):
                for store, key in reap:
                    store.delete_key(key)
            reap.clear()
        if submitted >= n_requests and ticks > drain_ticks:
            break  # safety valve: never loop forever on a stuck tier
    wall = time.perf_counter() - t0
    stats = tier.stats()
    dispatched = (stats["leaves"]["dispatched"]
                  if isinstance(tier, FrontierRouter)
                  else stats["dispatched"])
    out = {"requests": submitted, "wall_s": round(wall, 3),
           "virtual_s": round(clock(), 3), "ticks": ticks,
           "throughput_rps": round(submitted / wall, 1) if wall else 0.0,
           "dispatched": dispatched,
           "dispatch_rps": round(dispatched / wall, 1) if wall else 0.0,
           **led.summary()}
    if isinstance(tier, FrontierRouter):
        out["frontier"] = dict(tier.counters)
    return out


def run_stub_replay(spec: dict, n_requests: int, *, n_leaves: int = 1,
                    engines_per_leaf: int = 4, tick_s: float = 0.005,
                    dispatch_mode: str = "heap",
                    tokens_per_s: float = 250_000.0,
                    queue_limit: int = 4096,
                    **frontier_overrides) -> dict:
    """One-call stub-tier replay (bench + tests): build, run, report."""
    clock = VirtualClock()
    frontier, workers, _stores = build_stub_tier(
        n_leaves, engines_per_leaf, clock, queue_limit=queue_limit,
        tokens_per_s=tokens_per_s, dispatch_mode=dispatch_mode,
        **frontier_overrides)
    return replay(frontier, workers, clock, spec, n_requests,
                  tick_s=tick_s)


def _shard_key(tenant: Optional[str], prompt: np.ndarray,
               page_size: int = 16):
    """The frontier's hash key, reproduced for out-of-process shards:
    normalized tenant, or the first prompt page when untagged."""
    t = _acct.normalize_tenant(tenant)
    return t if t != _acct.DEFAULT_TENANT else prompt[:page_size].tobytes()


def run_leaf_shard(spec: dict, n_requests: int, leaf_names: List[str],
                   me: str, *, engines_per_leaf: int = 4,
                   tick_s: float = 0.005, queue_limit: int = 4096,
                   tokens_per_s: float = 250_000.0,
                   frontier_seed: int = 0) -> dict:
    """Replay ONE leaf's rendezvous share of the global stream, as its
    own process (one process per leaf). The full seeded stream is regenerated and filtered with the same hash the
    frontier uses, and each event keeps its GLOBAL gid-derived sampling
    seed — so N shards collectively replay exactly the 1-leaf workload
    and their summed dispatch rate is the federated tier's aggregate."""
    clock = VirtualClock()
    store = MemStore()
    leaf = Router(store, namespace=me, dataplane="store",
                  queue_limit=queue_limit, retain_results=False,
                  harvest_budget=1024, clock=clock)
    workers = [StubWorker(store, me, clock=clock, name=f"{me}e{j}",
                          num_slots=64, tokens_per_s=tokens_per_s)
               for j in range(engines_per_leaf)]
    led = ReplayLedger()
    reap: List[str] = []

    def _tap(req):
        led.resolve(req.rid, req)
        reap.append(k_done(me, req.rid))
    leaf.on_resolve = _tap

    def shard_events():
        """The first ``n_requests`` of the GLOBAL stream, filtered to
        the events rendezvous hashing assigns to this leaf — each with
        its global gid so the sampling seed matches the frontier's."""
        events = arrivals(spec)
        for gid in range(n_requests):
            ev = next(events)
            if rendezvous_rank(_shard_key(ev["tenant"], ev["prompt"]),
                               leaf_names, frontier_seed)[0] == me:
                yield gid, ev

    # materialize BEFORE the timer: every shard regenerates the full
    # global stream to filter it, and that serial cost would otherwise
    # dilute the dispatch-throughput scaling the bench is measuring
    gen_t0 = time.perf_counter()
    queued = list(shard_events())
    gen_s = time.perf_counter() - gen_t0
    stream = iter(queued)
    nxt = next(stream, None)
    submitted = 0
    t0 = time.perf_counter()
    while nxt is not None or led.resolved < submitted:
        now = clock()
        while nxt is not None and nxt[1]["t"] <= now:
            gid, ev = nxt
            leaf.submit(ev["prompt"], slo=ev["slo"],
                        tenant=ev["tenant"],
                        max_new_tokens=ev["max_new_tokens"],
                        seed=frontier_seed * 1_000_003 + gid)
            submitted += 1
            nxt = next(stream, None)
        leaf.pump()
        for w in workers:
            w.poll()
        clock.advance(tick_s)
        if len(reap) >= 4096:
            with deadline_guard("reap done keys"):
                for key in reap:
                    store.delete_key(key)
            reap.clear()
    wall = time.perf_counter() - t0
    stats = leaf.stats()
    return {"leaf": me, "requests": submitted,
            "wall_s": round(wall, 3), "gen_s": round(gen_s, 3),
            "dispatched": stats["dispatched"],
            "done": stats["done"], "shed": stats["shed"],
            "digest": led.digest}


def main(argv=None) -> int:
    """Shard entry point: ``python -m paddle_tpu_torch.serving.replay --shard
    leaf0 --leaves leaf0,leaf1 --requests 500000`` prints the shard's
    metrics JSON on stdout (the only stdout this module produces)."""
    import argparse
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.serving.replay")
    ap.add_argument("--shard", required=True)
    ap.add_argument("--leaves", required=True,
                    help="comma-separated leaf names (global topology)")
    ap.add_argument("--requests", type=int, required=True,
                    help="GLOBAL stream length the shard filters")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default="mixed")
    ap.add_argument("--rate-rps", type=float, default=20_000.0)
    ap.add_argument("--engines", type=int, default=4)
    ap.add_argument("--tokens-per-s", type=float, default=250_000.0)
    ap.add_argument("--tick-s", type=float, default=0.005)
    ap.add_argument("--tagged-share", type=float, default=0.8,
                    help="fraction of tagged traffic; 0 shards every "
                         "request by prompt page (uniform balance)")
    args = ap.parse_args(argv)
    spec = make_spec(args.profile, seed=args.seed, rate_rps=args.rate_rps,
                     tagged_share=args.tagged_share)
    out = run_leaf_shard(spec, args.requests,
                         args.leaves.split(","), args.shard,
                         engines_per_leaf=args.engines,
                         tick_s=args.tick_s,
                         tokens_per_s=args.tokens_per_s)
    print(json.dumps(out), file=sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
