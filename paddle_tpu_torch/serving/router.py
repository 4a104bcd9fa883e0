"""SLO-aware, role-aware request router over a fleet of engine workers
(counterpart of ``paddle_tpu/serving/router.py``).

The router is the serving control plane: clients submit prompts tagged
with an SLO class, the router admits or sheds them against a bounded
queue, and each ``pump()`` round dispatches queued work to the live
engine fleet discovered through the coordination store. On the default
``streaming`` dataplane the router keeps one persistent transport
connection per worker (serving/transport.py): dispatches go out as
batched wire frames, completions and occupancy beats come back on the
same sockets, and the store is demoted to membership + failover ground
truth (``dataplane="store"`` keeps the legacy store-key hot path for
A/B runs; a worker whose socket drops gets its frames re-written as
store keys, so the wire is never a new way to lose work).

Placement is least-outstanding-tokens — the engine-reported occupancy
plus the load this router dispatched but the engine has not yet acked —
softened by prefix affinity: a request whose chain-hashed prompt blocks
were last served by a particular engine routes back there (reusing that
engine's paged prefix cache) unless the load skew exceeds the affinity
slack. The least-loaded engine comes off a lazy-invalidation min-heap
(``dispatch_mode="heap"``, O(log E) per dispatch): loads are computed
once per dispatch round and updated incrementally as work is placed, so
a burst of R requests over E engines costs O(R log E) instead of the
O(R·E·inflight) full rescan. ``dispatch_mode="scan"`` keeps the original
scan as the bit-identical placement oracle for A/B runs — the heap's
(load, engine index) ordering reproduces the scan's tie-break exactly.

Workers registered with ``role="prefill"`` never decode: long
prompts (``prefill_threshold_tokens``) are placed on the prefill worker
with the shallowest queue, which streams the finished KV pages straight
to the chosen decode worker (``kv_to`` in the dispatch record); short
prompts — and everything, when no prefill worker is registered — take
the classic unified path.

Overload policy: when the queue is full an incoming request preempts the
youngest request of a strictly lower SLO class, otherwise it is itself
shed. Shedding is always explicit — a counter, an event, and a
``RuntimeError`` from ``result`` naming the reason (queue_full or
deadline) — never a silent drop.

Failover: a worker whose occupancy beat stalls past the grace window is
declared dead (beats ride the wire as heartbeats AND the store as the
slow mirror; either source only counts when the beat ADVANCES). Its
finished work is harvested from ``done`` keys (workers write those
before acking — the wire ``done`` frames are an echo, the store is the
ground truth), and everything else is resubmitted to the FRONT of its
class queue. Reruns are bit-equal because the router stamps every
request with an explicit sampling seed at admission, so placement —
including a rerun of a disaggregated request as a unified one — is
invisible in the token streams (no loss, no duplicates, no drift).
Dispatch frames lost in flight are retransmitted once the worker's
``acked_seq`` stalls past ``retransmit_s`` (idempotent: workers skip
consumed seqs), with a store-key write alongside so even a half-open
socket cannot wedge a request.

This module is the single writer of the ``serving_router_*`` telemetry
family, and every store call sits under ``protocol.deadline_guard``.

Tracing: with telemetry enabled the router mints one trace per admitted
request and owns its router-side spans — ``srv_request`` (the root,
submit through result), ``srv_admit``, ``srv_queue``, ``srv_dispatch``
and ``srv_retry`` (failover resubmission windows, retry=True). The trace
context rides the dispatch record (protocol.py) so the worker and engine
continue the same tree; failover reruns attach under the same root,
never minting a second one.

Live telemetry: under ``PADDLE_TPU_LIVE_TELEMETRY=1`` each ``pump``
ingests the workers' ``tele`` frames into a ``live.LiveAggregator`` and
ticks it (admission-queue and outstanding-token gauges included), which
writes ``fleet_health.json`` at its cadence. ``share_live_aggregator``
hands that role to an aggregator someone else owns (the front tier,
``serving/frontier.py``).
"""
from __future__ import annotations

import heapq
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import observability as _obs
from ..observability import live as _live
from ..observability import accounting as _acct
from ..inference.engine import PrefixRegistry, SamplingParams
from .protocol import (DEFAULT_DEADLINES, DEFAULT_NAMESPACE, SLO_CLASSES,
                       deadline_guard, k_ctl, k_done, k_engine, k_occ,
                       k_req, k_count, pack, unpack)
from .transport import TransportClient

__all__ = ["Router", "RouterConfig", "RouterRequest"]

#: bound on the prefix-affinity LRU (block-key -> engine name entries)
_AFFINITY_CAP = 65536

#: store-mirror cadence: how often the streaming router re-reads the
#: store occupancy copies (wire beats are the hot liveness signal)
_STORE_MIRROR_S = 0.25


@dataclass
class RouterConfig:
    namespace: str = DEFAULT_NAMESPACE
    #: "streaming" rides persistent transport sockets; "store" is the
    #: legacy store-key dataplane (kept for A/B benches and fallback)
    dataplane: str = "streaming"
    #: total queued (not yet dispatched) requests across all SLO classes
    queue_limit: int = 64
    #: seconds from submit before a still-queued request is shed, per class
    deadlines: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_DEADLINES))
    #: occupancy beat staleness past which an engine is declared dead
    engine_grace_s: float = 5.0
    #: outstanding-token skew an affinity route may cost before the
    #: router abandons cache reuse for load balance
    affinity_slack_tokens: int = 512
    #: dispatched-but-unfinished requests allowed per engine
    #: (0 = twice the engine's slot count)
    max_inflight_per_engine: int = 0
    #: prompt block size for affinity chain hashes — match the engines'
    #: page_size or affinity keys never line up with their prefix caches
    page_size: int = 16
    #: prompts at least this long go to a prefill-role worker (when one
    #: is alive) and stream their KV pages to the decode worker; shorter
    #: prompts prefill where they decode
    prefill_threshold_tokens: int = 64
    #: seconds of acked_seq stall before unacked wire dispatches are
    #: retransmitted (and mirrored to the store)
    retransmit_s: float = 1.0
    #: base of the per-request sampling seeds the router assigns so
    #: reruns after failover are bit-equal on any engine
    seed: int = 0
    #: engine-selection strategy: "heap" pops the least-loaded engine
    #: off a lazy-invalidation min-heap rebuilt once per dispatch round
    #: (O(log E) per placement); "scan" is the original full O(E) scan,
    #: kept as the bit-identical placement oracle for A/B runs
    dispatch_mode: str = "heap"
    #: per-pump budget of done-key store probes during harvest (0 =
    #: unbounded). A rotating engine cursor carries the scan across
    #: pumps so deep inflight books make progress fairly instead of
    #: stalling the pump on one store round-trip per in-flight rid.
    harvest_budget: int = 256
    #: keep resolved requests in the book so ``status``/``result`` work
    #: after the fact. The replay harness turns this off (reading
    #: results through ``on_resolve`` instead) so million-request runs
    #: stay memory-bounded.
    retain_results: bool = True


@dataclass
class RouterRequest:
    rid: int
    prompt: np.ndarray
    params: SamplingParams
    slo: str
    submit_t: float
    deadline_t: float
    block_keys: List[bytes]
    status: str = "queued"  # queued | dispatched | done | failed | shed
    #: cost-attribution label (observability/accounting.py); "-" = the
    #: untagged default, which adds zero wire bytes to dispatch records
    tenant: str = "-"
    engine: Optional[str] = None
    seq: int = -1
    tokens: Optional[np.ndarray] = None
    error: Optional[str] = None
    shed_reason: Optional[str] = None
    #: clock stamp of the dispatch that placed this request on an engine
    #: (None while queued / for sheds) — admission latency is
    #: ``dispatch_t - submit_t``
    dispatch_t: Optional[float] = None
    finish_t: Optional[float] = None
    resubmits: int = 0
    trace_id: Optional[str] = None
    #: disaggregated path: name of the prefill engine streaming KV pages
    #: to ``engine`` (None on the unified path)
    kv_from: Optional[str] = None
    #: engine whose seq stream carries this dispatch (the prefill engine
    #: for disaggregated requests) + the wire record for retransmits
    wire_engine: Optional[str] = None
    wire_rec: Optional[dict] = None


@dataclass
class _EngineState:
    name: str
    index: int
    record: dict
    occ: dict = field(default_factory=dict)
    beat: int = -1
    acked_seq: int = 0
    next_seq: int = 0
    #: engine-reported completions already scanned for (-1 = never scanned)
    harvested_done: int = -1
    last_change: float = 0.0
    alive: bool = True
    #: rid -> RouterRequest, dispatch order (oldest first). Disaggregated
    #: requests appear in BOTH their prefill and decode engine's map
    #: until the relay/done frame retires them.
    inflight: "OrderedDict[int, RouterRequest]" = field(
        default_factory=OrderedDict)
    #: streaming dataplane: persistent connection to this worker
    link: Optional[TransportClient] = None
    #: link.reconnects value the last hello was sent on (-1 = never)
    hello_sent: int = -1
    #: dispatch records built this pump, flushed as one batched frame
    outbox: List[dict] = field(default_factory=list)
    #: monotonic stamp of the last ack progress (retransmit timer)
    last_ack_t: float = 0.0

    @property
    def role(self) -> str:
        return self.record.get("role", "unified")

    @property
    def draining(self) -> bool:
        """Fleet-supervisor drain order in effect (engine-advertised via
        its occupancy beat): finish in-flight work, place nothing new."""
        return bool(self.occ.get("draining"))

    @property
    def addr(self) -> Optional[str]:
        return self.record.get("addr")


class Router:
    """Admit, place, and track requests across the registered engines."""

    def __init__(self, store, config: Optional[RouterConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 **overrides):
        if config is None:
            config = RouterConfig(**overrides)
        elif overrides:
            raise ValueError("pass config= or field overrides, not both")
        for cls in config.deadlines:
            if cls not in SLO_CLASSES:
                raise ValueError(f"unknown SLO class {cls!r}")
        if config.dataplane not in ("streaming", "store"):
            raise ValueError(
                f"dataplane must be streaming|store, got "
                f"{config.dataplane!r}")
        if config.dispatch_mode not in ("heap", "scan"):
            raise ValueError(
                f"dispatch_mode must be heap|scan, got "
                f"{config.dispatch_mode!r}")
        self.config = config
        self._store = store
        #: injectable time source (the replay harness drives a virtual
        #: clock through here so deadline sheds, liveness grace, and
        #: retransmit timers are deterministic functions of the workload
        #: instead of wall time). None = real time: perf_counter for
        #: request timing, monotonic for liveness.
        self._clock = clock
        self._ns = config.namespace
        self._engines: Dict[str, _EngineState] = {}
        self._by_index: Dict[int, _EngineState] = {}
        self._queues: Dict[str, deque] = {c: deque() for c in SLO_CLASSES}
        self._requests: Dict[int, RouterRequest] = {}
        self._affinity: "OrderedDict[bytes, str]" = OrderedDict()
        self._next_rid = 0
        self._known_engines = 0
        self._last_occ_read = -float("inf")
        #: rid -> open span handles ("root", "queue", "retry"); entries
        #: exist only while telemetry is on and the request is unresolved
        self._tspans: Dict[int, dict] = {}
        self.counters = {"submitted": 0, "done": 0, "failed": 0, "shed": 0,
                         "dispatched": 0, "failover_resubmits": 0,
                         "affinity_hits": 0, "engines_lost": 0,
                         "retransmits": 0, "disagg_dispatches": 0}
        #: live-telemetry aggregator (observability/live.py), created
        #: lazily on the first pump with the plane enabled; stays None —
        #: one env dict lookup per pump — when it is off
        self._live_agg: Optional[_live.LiveAggregator] = None
        #: router-side tenant ledger (shed attribution), created lazily
        #: on the first submit with accounting enabled
        self._acct: Optional[_acct.TenantLedger] = None
        #: called with each request as it resolves (done/failed/shed) —
        #: the replay harness's completion tap; with
        #: ``retain_results=False`` this is the only way results leave
        #: the router
        self.on_resolve: Optional[Callable[[RouterRequest], None]] = None
        #: harvest rotation: which engine the budgeted done-key scan
        #: resumes from next pump
        self._harvest_cursor = 0
        #: False when another owner (share_live_aggregator) drives the
        #: shared live aggregator: this router feeds tenant deltas but
        #: leaves queue gauges + the health-file tick to the owner
        self._live_driver = True

    @property
    def _streaming(self) -> bool:
        return self.config.dataplane == "streaming"

    def _now(self) -> float:
        """Request-timing clock (submit/dispatch/finish/deadlines)."""
        return self._clock() if self._clock is not None \
            else time.perf_counter()

    def _mono(self) -> float:
        """Liveness clock (beats, grace windows, retransmit timers).
        Same source as ``_now`` when a virtual clock is injected."""
        return self._clock() if self._clock is not None \
            else time.monotonic()

    # -- admission -----------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               slo: str = "standard", tenant: Optional[str] = None,
               **sampling) -> int:
        """Admit a request (or shed it under overload). Returns its rid;
        a shed request keeps the rid so ``status``/``result`` can report
        the rejection. ``tenant`` labels the request for per-tenant cost
        accounting (docs/OBSERVABILITY.md §11); absent it attributes to
        the "-" default and adds zero wire bytes."""
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {slo!r}; expected one of {SLO_CLASSES}")
        if params is None:
            params = SamplingParams(**sampling)
        elif sampling:
            raise ValueError("pass params= or sampling kwargs, not both")
        if self._acct is None and _acct.enabled():
            self._acct = _acct.TenantLedger()
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if params.seed is None:
            # explicit seed => bit-equal streams on ANY engine, which is
            # what makes failover reruns invisible in the results
            params = replace(params, seed=self.config.seed * 1_000_003
                             + self._next_rid)
        now = self._now()
        req = RouterRequest(
            rid=self._next_rid, prompt=prompt, params=params, slo=slo,
            submit_t=now,
            deadline_t=now + self.config.deadlines.get(
                slo, DEFAULT_DEADLINES[slo]),
            block_keys=PrefixRegistry.block_keys(
                prompt, self.config.page_size))
        # normalize unconditionally: every downstream consumer (shed
        # attribution, quota buckets, ledger cells) keys on the
        # NORMALIZED label, so a raw "" / "  acme " / control-char label
        # can never mint a ledger row distinct from its canonical form —
        # and the untagged "-" default can never alias a tagged tenant
        req.tenant = _acct.normalize_tenant(tenant)
        self._next_rid += 1
        self._requests[req.rid] = req
        self.counters["submitted"] += 1
        _obs.inc("serving_router_requests_total")
        if _obs.enabled():
            # one trace per admitted request; the id travels the wire so
            # the worker's and engine's spans join this tree
            root = _obs.start_span(
                "srv_request", trace_id=_obs.new_trace_id(), rid=req.rid,
                slo=slo, tenant=req.tenant,
                prompt_tokens=int(prompt.size))
            req.trace_id = root.trace_id
            self._tspans[req.rid] = {"root": root}
            ta = time.perf_counter()
            self._admit(req)
            _obs.record_span("srv_admit", trace_id=root.trace_id,
                             parent_id=root.span_id,
                             dur_s=time.perf_counter() - ta,
                             outcome=req.status)
            if req.status == "queued":
                self._tspans[req.rid]["queue"] = _obs.start_span(
                    "srv_queue", trace_id=root.trace_id,
                    parent_id=root.span_id, slo=slo)
        else:
            self._admit(req)
        _obs.set_gauge("serving_router_queue_depth", self._queue_depth())
        return req.rid

    def _queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _admit(self, req: RouterRequest):
        if self._queue_depth() < self.config.queue_limit:
            self._queues[req.slo].append(req)
            return
        # full: preempt the youngest request of a strictly lower class,
        # else the incoming request itself is the lowest and is shed
        for cls in SLO_CLASSES:
            if cls == req.slo:
                break
            if self._queues[cls]:
                victim = self._queues[cls].pop()
                self._shed(victim, "queue_full")
                self._queues[req.slo].append(req)
                return
        self._shed(req, "queue_full")

    def _shed(self, req: RouterRequest, reason: str):
        req.status = "shed"
        req.shed_reason = reason
        req.finish_t = self._now()
        self.counters["shed"] += 1
        if self._acct is not None:
            self._acct.add(req.tenant, req.slo, shed_requests=1)
        _obs.inc("serving_router_shed_total")
        _obs.event("serving_router_shed", rid=req.rid, slo=req.slo,
                   tenant=req.tenant, reason=reason)
        t = self._tspans.pop(req.rid, None)
        if t:
            for k in ("queue", "retry"):
                if t.get(k):
                    _obs.end_span(t[k], outcome="shed")
            _obs.end_span(t["root"], status="shed", reason=reason)
        self._resolved(req)

    def _resolved(self, req: RouterRequest):
        """Terminal-transition tap: report the request to ``on_resolve``
        and, unless results are retained, drop it from the book so the
        request map stays bounded over million-request replays."""
        cb = self.on_resolve
        if cb is not None:
            cb(req)
        if not self.config.retain_results:
            self._requests.pop(req.rid, None)

    # -- fleet discovery & liveness -----------------------------------------

    def _discover(self):
        with deadline_guard("discover engines"):
            count = int(self._store.add(k_count(self._ns), 0))
        while self._known_engines < count:
            idx = self._known_engines
            key = k_engine(self._ns, idx)
            with deadline_guard("discover engines"):
                if not self._store.check(key):
                    return  # registration record not written yet; retry
                record = unpack(self._store.get(key))
            now = self._mono()
            est = _EngineState(name=record["name"], index=idx, record=record,
                               last_change=now, last_ack_t=now)
            if self._streaming and record.get("addr"):
                # fail-soft dial: a worker that listens but is not yet
                # polling still accepts (backlog); a dead addr backs off
                est.link = TransportClient(record["addr"],
                                           seed=self.config.seed)
            self._engines[est.name] = est
            self._by_index[idx] = est
            self._known_engines = idx + 1
            _obs.event("serving_router_engine_up", name=est.name, index=idx,
                       role=est.role)
            _obs.set_gauge("serving_router_engines", self._alive_count())

    def _alive_count(self) -> int:
        return sum(1 for e in self._engines.values() if e.alive)

    def _apply_occ(self, est: _EngineState, occ: dict, now: float):
        """Adopt an occupancy beat from EITHER source. Only an ADVANCING
        beat refreshes liveness — the slow store mirror lags the wire, and
        a stale copy must never resurrect a silent worker."""
        beat = int(occ.get("beat", -1))
        if beat <= est.beat:
            return
        est.beat = beat
        est.occ = occ
        est.acked_seq = int(occ.get("acked_seq", 0))
        est.last_change = now

    def _pump_wire(self):
        """Streaming dataplane intake: (re)introduce ourselves after
        (re)connects, then drain every worker connection — occupancy
        heartbeats, completion echoes, and prefill->decode relay
        notices."""
        if not self._streaming:
            return
        now = self._mono()
        for est in self._engines.values():
            link = est.link
            if link is None:
                continue
            if link.connected() and est.hello_sent != link.reconnects:
                if link.send({"t": "hello", "peer": "router",
                              "name": "router"}):
                    est.hello_sent = link.reconnects
            for frame in link.poll():
                t = frame.get("t")
                if t == "occ":
                    if est.alive:
                        self._apply_occ(est, frame.get("occ", {}), now)
                elif t == "done":
                    for rec in frame.get("recs", ()):
                        self._finish_from_wire(rec)
                elif t == "relay":
                    # the prefill engine handed these rids' KV pages to
                    # their decode engine; the decode side owns them now
                    for rid in frame.get("rids", ()):
                        est.inflight.pop(rid, None)
                elif t == "tele":
                    # live-telemetry batch riding the heartbeat; ingest
                    # dedups (src, seq) so the redundant re-sends and any
                    # locally tailed copies of the same spans collapse
                    if self._live_agg is not None:
                        for pay in frame.get("pays", ()):
                            self._live_agg.ingest(pay)

    def _read_occupancy(self):
        now = self._mono()
        if self._streaming:
            # the wire carries the hot beats; the store copy is only the
            # failover mirror and needs no more than the mirror cadence
            if now - self._last_occ_read < _STORE_MIRROR_S:
                return
        self._last_occ_read = now
        # one guard over the whole sweep: a guard arms a watchdog timer
        # (a thread), and per-engine guards made the mirror read cost
        # O(E) thread spawns per pump in the replay hot loop
        beats = []
        with deadline_guard("read occupancy"):
            for est in self._engines.values():
                if not est.alive:
                    continue
                key = k_occ(self._ns, est.name)
                if not self._store.check(key):
                    continue
                beats.append((est, unpack(self._store.get(key))))
        for est, occ in beats:
            self._apply_occ(est, occ, now)

    def _failover_dead(self):
        now = self._mono()
        for est in self._engines.values():
            if not est.alive:
                continue
            if now - est.last_change <= self.config.engine_grace_s:
                continue
            est.alive = False
            self.counters["engines_lost"] += 1
            _obs.event("serving_router_engine_dead", name=est.name,
                       inflight=len(est.inflight))
            _obs.set_gauge("serving_router_engines", self._alive_count())
            self._reassign_inflight(est, why="dead")

    def _reassign_inflight(self, est: _EngineState, why: str) -> int:
        """Harvest everything the engine already finished (done keys are
        written before the ack), then resubmit the rest to the FRONT of
        their class queues so failover does not add queueing delay on
        top of the rerun. Shared by dead-engine failover and supervisor
        drain-timeout evacuation; returns how many were resubmitted."""
        resubmit, finished = [], []
        with deadline_guard("harvest results"):
            for rid, req in list(est.inflight.items()):
                if self._store.check(k_done(self._ns, rid)):
                    finished.append(
                        (req, unpack(self._store.get(k_done(self._ns,
                                                            rid)))))
                else:
                    resubmit.append(req)
        for req, rec in finished:
            self._finish_with(req, rec)
        est.inflight.clear()
        for req in reversed(resubmit):
            # a disaggregated request dies with EITHER of its engines:
            # drop it from the partner's book too and rerun from
            # scratch (fresh prefill — bit-equal, the seed is explicit)
            self._resolve_inflight(req.rid)
            req.status = "queued"
            req.engine = None
            req.seq = -1
            req.kv_from = None
            req.wire_engine = None
            req.wire_rec = None
            req.resubmits += 1
            self._queues[req.slo].appendleft(req)
            self.counters["failover_resubmits"] += 1
            _obs.inc("serving_router_failover_total")
            _obs.event("serving_router_failover", rid=req.rid,
                       engine=est.name, slo=req.slo, why=why)
            t = self._tspans.get(req.rid)
            if t:
                # retry-flagged child under the SAME root: the window
                # from declared-dead through this request's redispatch
                t["retry"] = _obs.start_span(
                    "srv_retry", trace_id=t["root"].trace_id,
                    parent_id=t["root"].span_id, retry=True,
                    engine=est.name, resubmit=req.resubmits)
        return len(resubmit)

    def evacuate(self, name: str) -> int:
        """Hand a LIVE engine's in-flight requests off to the rest of
        the fleet — the fleet supervisor's drain-timeout escape hatch.
        The engine is not declared dead: it stays registered (its drain
        order already excludes it from placement). Reruns are bit-equal
        (router-assigned seeds), and a rid the drained engine still
        finishes is harmless — done records are keyed by rid, so the
        first finish wins and the duplicate write is identical."""
        est = self._engines.get(name)
        if est is None or not est.alive:
            return 0
        # adopt the drain locally: a wedged worker never refreshes its
        # occupancy beat, and waiting for one would re-place the
        # evacuated work right back on the engine being evacuated
        est.occ = dict(est.occ, draining=True)
        return self._reassign_inflight(est, why="evacuate")

    # -- results -------------------------------------------------------------

    def _resolve_inflight(self, rid: int):
        """Drop a rid from every engine's book (a disaggregated request
        is tracked on both its prefill and decode engine)."""
        for est in self._engines.values():
            est.inflight.pop(rid, None)

    def _finish_with(self, req: RouterRequest, rec: dict):
        self._resolve_inflight(req.rid)
        req.finish_t = self._now()
        if "error" in rec:
            req.status = "failed"
            req.error = rec["error"]
            self.counters["failed"] += 1
        else:
            req.status = "done"
            req.tokens = np.asarray(rec["tokens"], dtype=np.int64)
            self.counters["done"] += 1
            _obs.observe("serving_router_request_seconds",
                         req.finish_t - req.submit_t)
        t = self._tspans.pop(req.rid, None)
        if t:
            for k in ("queue", "retry"):
                if t.get(k):
                    _obs.end_span(t[k], engine=req.engine)
            _obs.end_span(t["root"], status=req.status, engine=req.engine,
                          resubmits=req.resubmits)
        self._resolved(req)

    def _finish_from_store(self, req: RouterRequest):
        with deadline_guard("harvest results"):
            rec = unpack(self._store.get(k_done(self._ns, req.rid)))
        self._finish_with(req, rec)

    def _finish_from_wire(self, rec: dict):
        """A ``done`` frame: trust it directly — the worker wrote the
        store key BEFORE sending it (done-before-ack), so acting on the
        echo can never outrun the ground truth. Late echoes for requests
        already resolved (or resubmitted after a failover) are dropped."""
        req = self._requests.get(rec.get("rid"))
        if req is None or req.status != "dispatched":
            return
        self._finish_with(req, rec)

    def _harvest_done(self):
        """Scan in-flight rids for finished store records, at most
        ``harvest_budget`` probes per pump. A rotating engine cursor
        resumes where the budget ran out, and an engine only commits its
        ``harvested_done`` watermark after a COMPLETE scan — a truncated
        one retries next pump, so bounding the work never strands a
        finished result."""
        names = [n for n, e in self._engines.items() if e.inflight]
        if not names:
            return
        budget = self.config.harvest_budget
        spent = 0
        start = self._harvest_cursor % len(names)
        for off in range(len(names)):
            est = self._engines[names[(start + off) % len(names)]]
            # only scan done keys when the engine's beat advertises new
            # completions: per-rid checks are store round trips, and with
            # deep inflight queues a blind every-pump scan contends the
            # store against the engines' own traffic
            reported = int(est.occ.get("done_count", -1))
            if reported >= 0 and reported == est.harvested_done:
                continue
            finished, complete = [], True
            with deadline_guard("harvest results"):
                for rid, req in list(est.inflight.items()):
                    if req.status != "dispatched":
                        est.inflight.pop(rid, None)
                        continue
                    if budget > 0 and spent >= budget:
                        complete = False
                        break
                    spent += 1
                    if self._store.check(k_done(self._ns, rid)):
                        finished.append(
                            (req, unpack(self._store.get(
                                k_done(self._ns, rid)))))
            for req, rec in finished:
                self._finish_with(req, rec)
            if complete:
                est.harvested_done = reported
            else:
                # budget exhausted mid-engine: resume HERE next pump
                self._harvest_cursor = (start + off) % len(names)
                return
        self._harvest_cursor = start + len(names)

    # -- placement -----------------------------------------------------------

    def _engine_cap(self, est: _EngineState) -> int:
        if self.config.max_inflight_per_engine > 0:
            return self.config.max_inflight_per_engine
        return 2 * int(est.record.get("num_slots", 1))

    def _load_tokens(self, est: _EngineState) -> int:
        """Outstanding tokens the engine reported, plus dispatched work it
        has not acked yet (seq >= acked_seq) so burst dispatches between
        beats don't all pile onto the same engine. A request whose KV
        pages are streaming in from a prefill engine counts until it
        finishes — the decode engine's own occupancy may not see it yet
        (deliberate over-estimate; it errs toward spreading load)."""
        load = int(est.occ.get("outstanding_tokens", 0))
        for req in est.inflight.values():
            cost = len(req.prompt) + req.params.max_new_tokens
            if req.kv_from is not None:
                if req.engine == est.name:
                    load += cost
            elif req.seq >= est.acked_seq:
                load += cost
        return load

    def _pick_engine(self, req: RouterRequest):
        """(decode-capable engine, via_affinity) or (None, False) when no
        capacity. Prefill-role workers never decode and are excluded."""
        candidates = [e for e in self._engines.values()
                      if e.alive and e.role != "prefill"
                      and not e.draining
                      and len(e.inflight) < self._engine_cap(e)]
        if not candidates:
            return None, False
        loads = {e.name: self._load_tokens(e) for e in candidates}
        best = min(candidates, key=lambda e: (loads[e.name], e.index))
        # deepest prompt block we have seen routed somewhere live wins,
        # unless honoring it would skew load past the slack
        for key in reversed(req.block_keys):
            name = self._affinity.get(key)
            if name is None:
                continue
            est = self._engines.get(name)
            if est is None or est not in candidates:
                break
            if loads[name] - loads[best.name] \
                    <= self.config.affinity_slack_tokens:
                return est, True
            break
        return best, False

    def _placement_ctx(self) -> dict:
        """Heap-mode placement book, built once per dispatch round: the
        load of every decode-capable candidate plus a min-heap ordered
        (load, engine index) — the scan's exact tie-break. Entries go
        stale as dispatches charge load; ``_pick_engine_heap`` discards
        them lazily, so each placement costs O(log E) instead of the
        scan's O(E·inflight) recompute."""
        loads: Dict[str, int] = {}
        entries: List[Tuple[int, int, str]] = []
        for e in self._engines.values():
            if (e.alive and e.role != "prefill" and not e.draining
                    and len(e.inflight) < self._engine_cap(e)):
                load = self._load_tokens(e)
                loads[e.name] = load
                entries.append((load, e.index, e.name))
        heapq.heapify(entries)
        return {"loads": loads, "heap": entries}

    def _pick_engine_heap(self, req: RouterRequest, ctx: dict):
        """Heap-mode twin of ``_pick_engine``: same contract, same
        placement (including the affinity override), different cost."""
        loads, heap = ctx["loads"], ctx["heap"]
        while heap:
            load, index, name = heap[0]
            if name not in loads:
                heapq.heappop(heap)  # hit its cap mid-round; evicted
                continue
            if load != loads[name]:
                heapq.heappop(heap)  # stale load; refresh lazily
                heapq.heappush(heap, (loads[name], index, name))
                continue
            break
        if not heap:
            return None, False
        best_load, _, best_name = heap[0]
        # deepest prompt block we have seen routed somewhere live wins,
        # unless honoring it would skew load past the slack
        for key in reversed(req.block_keys):
            name = self._affinity.get(key)
            if name is None:
                continue
            if name not in loads:
                break
            if loads[name] - best_load <= self.config.affinity_slack_tokens:
                return self._engines[name], True
            break
        return self._engines[best_name], False

    def _charge_placement(self, ctx: Optional[dict], est: _EngineState,
                          req: RouterRequest):
        """Book a dispatch against the round's placement state: bump the
        engine's load (push a fresh heap entry; the stale one dies
        lazily) or drop it from candidacy once it reaches its inflight
        cap — mirroring exactly what the scan would recompute."""
        if ctx is None:
            return
        loads = ctx["loads"]
        if est.name not in loads:
            return
        if len(est.inflight) >= self._engine_cap(est):
            del loads[est.name]
            return
        loads[est.name] += len(req.prompt) + req.params.max_new_tokens
        heapq.heappush(ctx["heap"],
                       (loads[est.name], est.index, est.name))

    def _prefill_load(self, est: _EngineState) -> int:
        """Prefill placement signal: reported queue depth + handoffs
        dispatched but not yet acked."""
        load = int(est.occ.get("prefill_queue", 0))
        load += sum(1 for r in est.inflight.values()
                    if r.kv_from == est.name and r.seq >= est.acked_seq)
        return load

    def _pick_prefill(self, req: RouterRequest) -> Optional[_EngineState]:
        """Shallowest-queue live prefill worker, or None (unified path).
        Only the streaming dataplane can carry the KV stream."""
        if (not self._streaming
                or len(req.prompt) < self.config.prefill_threshold_tokens):
            return None
        candidates = [e for e in self._engines.values()
                      if e.alive and e.role == "prefill"
                      and not e.draining
                      and len(e.inflight) < self._engine_cap(e)]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda e: (self._prefill_load(e), e.index))

    def _build_rec(self, req: RouterRequest, est: _EngineState,
                   via_affinity: bool) -> dict:
        """Dispatch record on ``est``'s seq stream + the dispatch span.
        Shared by the unified and disaggregated paths."""
        req.seq = est.next_seq
        est.next_seq += 1
        # vars() not dataclasses.asdict(): SamplingParams is flat, and
        # asdict's recursive deep-copy walk is ~10x the cost — visible at
        # replay rates (a million dispatches per bench run)
        rec = {"rid": req.rid, "prompt": req.prompt.tolist(),
               "params": dict(vars(req.params))}
        if req.tenant != "-":
            # tenant + class ride the wire only when tagged: an untagged
            # request's dispatch record is byte-identical to before the
            # accounting plane existed (zero wire cost when unused)
            rec["tenant"] = req.tenant
            rec["slo"] = req.slo
        t = self._tspans.get(req.rid)
        if t:
            root = t["root"]
            for k in ("queue", "retry"):
                h = t.pop(k, None)
                if h:
                    _obs.end_span(h, engine=est.name)
            dh = _obs.start_span(
                "srv_dispatch", trace_id=root.trace_id,
                parent_id=root.span_id, engine=est.name, seq=req.seq,
                retry=req.resubmits > 0, affinity=via_affinity)
            # cross-process context: worker + engine continue this trace
            # (dispatch_ts is WALL clock — the worker closes the transit
            # span against it)
            rec["trace"] = {"trace_id": root.trace_id,
                            "parent_id": root.span_id,
                            "resubmits": req.resubmits,
                            "dispatch_ts": time.time()}
            _obs.end_span(dh)
        return rec

    def _enqueue_rec(self, est: _EngineState, rec: dict,
                     req: RouterRequest):
        """Hand the record to the dataplane via the engine's outbox —
        flushed once per engine per pump as a single wire frame, or (on
        the store path / a dead link) as one batched store-key write, so
        a dispatch burst costs one guard instead of one per record."""
        rec["seq"] = req.seq
        if self._streaming and est.link is not None:
            req.wire_engine = est.name
            req.wire_rec = rec
        est.outbox.append(rec)

    def _note_affinity(self, req: RouterRequest, name: str):
        for key in req.block_keys:
            self._affinity[key] = name
            self._affinity.move_to_end(key)
        while len(self._affinity) > _AFFINITY_CAP:
            self._affinity.popitem(last=False)

    def _dispatch_one(self, req: RouterRequest, est: _EngineState,
                      via_affinity: bool = False):
        rec = self._build_rec(req, est, via_affinity)
        self._enqueue_rec(est, rec, req)
        req.status = "dispatched"
        req.engine = est.name
        req.dispatch_t = self._now()
        est.inflight[req.rid] = req
        self.counters["dispatched"] += 1
        _obs.inc("serving_router_dispatch_total")
        self._note_affinity(req, est.name)

    def _dispatch_disagg(self, req: RouterRequest, pe: _EngineState,
                         de: _EngineState, via_affinity: bool):
        """Disaggregated placement: the record rides the PREFILL engine's
        seq stream and names the decode target (``kv_to``); the request is
        booked on both engines until the relay frame retires the prefill
        side. Affinity follows the decode engine — that is where the KV
        pages (and the registered prefix blocks) land."""
        rec = self._build_rec(req, pe, via_affinity)
        rec["kv_to"] = {"addr": de.addr, "name": de.name}
        req.kv_from = pe.name
        self._enqueue_rec(pe, rec, req)
        req.status = "dispatched"
        req.engine = de.name
        req.dispatch_t = self._now()
        pe.inflight[req.rid] = req
        de.inflight[req.rid] = req
        self.counters["dispatched"] += 1
        self.counters["disagg_dispatches"] += 1
        _obs.inc("serving_router_dispatch_total")
        self._note_affinity(req, de.name)

    def _dispatch(self):
        now = self._now()
        heap_mode = self.config.dispatch_mode == "heap"
        ctx = None  # built lazily on the first placement of the round
        for cls in reversed(SLO_CLASSES):  # interactive drains first
            queue = self._queues[cls]
            while queue:
                req = queue[0]
                if now > req.deadline_t:
                    queue.popleft()
                    self._shed(req, "deadline")
                    continue
                if heap_mode:
                    if ctx is None:
                        ctx = self._placement_ctx()
                    est, via_affinity = self._pick_engine_heap(req, ctx)
                else:
                    est, via_affinity = self._pick_engine(req)
                if est is None:
                    self._flush_outboxes()
                    return  # fleet saturated; lower classes wait too
                queue.popleft()
                if via_affinity:
                    self.counters["affinity_hits"] += 1
                    _obs.inc("serving_router_affinity_hits_total")
                pe = self._pick_prefill(req)
                if pe is not None:
                    self._dispatch_disagg(req, pe, est, via_affinity)
                else:
                    self._dispatch_one(req, est, via_affinity)
                self._charge_placement(ctx, est, req)
        self._flush_outboxes()
        _obs.set_gauge("serving_router_queue_depth", self._queue_depth())

    def _flush_outboxes(self):
        """One batched dispatch frame per engine per pump. The store
        dataplane (and a wire send that fails) writes the whole batch
        under ONE guard — the worker merges both sources by seq, so the
        fallback is ordering-safe and idempotent."""
        for est in self._engines.values():
            if not est.outbox:
                continue
            batch, est.outbox = est.outbox, []
            if self._streaming and est.link is not None and est.link.send(
                    {"t": "dispatch", "reqs": batch}):
                continue
            with deadline_guard("dispatch request"):
                for rec in batch:
                    self._store.set(k_req(self._ns, est.name, rec["seq"]),
                                    pack(rec))

    def _retransmit(self):
        """Re-send wire dispatches a worker has not acked within
        ``retransmit_s`` — and mirror them to the store, so even a
        half-open socket (sends 'succeed', peer never sees them) cannot
        wedge a request. Idempotent end to end: workers skip seqs below
        their consume cursor, and the store key for a consumed seq is
        never re-read."""
        if not self._streaming:
            return
        now = self._mono()
        for est in self._engines.values():
            if not est.alive:
                continue
            unacked = [r for r in est.inflight.values()
                       if r.wire_engine == est.name and r.wire_rec is not None
                       and r.seq >= est.acked_seq
                       and r.status == "dispatched"]
            if not unacked:
                est.last_ack_t = now
                continue
            if now - est.last_ack_t < self.config.retransmit_s:
                continue
            est.last_ack_t = now
            unacked.sort(key=lambda r: r.seq)
            recs = [r.wire_rec for r in unacked]
            self.counters["retransmits"] += len(recs)
            _obs.event("serving_router_retransmit", engine=est.name,
                       seqs=[r.seq for r in unacked])
            if est.link is not None:
                est.link.send({"t": "dispatch", "reqs": recs})
            with deadline_guard("dispatch request"):
                for rec in recs:
                    self._store.set(k_req(self._ns, est.name, rec["seq"]),
                                    pack(rec))

    # -- driving -------------------------------------------------------------

    def _export_load_gauges(self):
        """Per-engine outstanding-token and per-class admission-queue
        gauges — the placement signals, exported so the live plane (and
        any scraper) sees the same numbers the dispatcher acts on."""
        if not _obs.enabled():
            return
        for est in self._engines.values():
            if est.alive:
                _obs.set_gauge("serving_router_engine_outstanding_tokens",
                               self._load_tokens(est), engine=est.name)
        for cls, queue in self._queues.items():
            _obs.set_gauge("serving_router_admission_queue_length",
                           len(queue), slo=cls)

    def _live_tick(self):
        """Drive the live aggregator (lazily created so tests can flip
        the env per-case): hand it the queue depths, then let it poll
        local tails and write ``fleet_health.json`` at its own cadence.
        One env dict lookup per pump when the plane is off; with
        accounting on, the per-engine per-tenant outstanding-token gauges
        are published either way."""
        if self._live_agg is None:
            if not self._live_driver or not _live.live_enabled():
                if self._acct is not None:
                    _acct.publish_outstanding(self.tenant_outstanding())
                return
            self._live_agg = _live.LiveAggregator()
        if self._live_driver:
            self._live_agg.note_queues({
                "admission": {c: len(q) for c, q in self._queues.items()},
                "engine_outstanding_tokens": {
                    e.name: self._load_tokens(e)
                    for e in self._engines.values() if e.alive},
            })
        if self._acct is not None:
            per_engine = self.tenant_outstanding()
            _acct.publish_outstanding(per_engine)
            # a non-driver router feeds only its ledger delta: the owner
            # merges every router's outstanding map itself, and a
            # per-router overwrite here would clobber its siblings'
            self._live_agg.note_tenants(
                self._acct.collect_delta(),
                per_engine if self._live_driver else None)
        if self._live_driver:
            self._live_agg.tick()

    def tenant_outstanding(self) -> Dict[str, Dict[str, int]]:
        """Per-engine per-tenant outstanding tokens: the raw signal the
        quota ladder gates on (gauges set by accounting.py — single
        writer — and mirrored into fleet_health.json)."""
        per_engine: Dict[str, Dict[str, int]] = {}
        for est in self._engines.values():
            if not est.alive:
                continue
            for req in est.inflight.values():
                if req.status != "dispatched":
                    continue
                by = per_engine.setdefault(est.name, {})
                by[req.tenant] = by.get(req.tenant, 0) + len(
                    req.prompt) + req.params.max_new_tokens
        return per_engine

    def share_live_aggregator(self, agg: "_live.LiveAggregator"):
        """Adopt a live aggregator OWNED BY SOMEONE ELSE (the front tier,
        ``serving/frontier.py``). This router keeps feeding
        tenant deltas and ingesting wire telemetry into it, but stops
        writing queue gauges or driving the health-file tick — with
        several routers in one process, two drivers would clobber each
        other's ``fleet_health.json`` view; the owner merges and writes."""
        self._live_agg = agg
        self._live_driver = False

    def pump(self):
        """One scheduling round: discover new engines, drain the wire,
        refresh the store occupancy mirror, fail over dead workers,
        retransmit stalled dispatches, harvest finished results,
        dispatch."""
        self._discover()
        self._pump_wire()
        self._read_occupancy()
        self._failover_dead()
        self._retransmit()
        self._harvest_done()
        self._dispatch()
        _obs.set_gauge("serving_router_queue_depth", self._queue_depth())
        self._export_load_gauges()
        self._live_tick()

    def pending(self) -> int:
        """Requests admitted but not yet finished (queued + in flight)."""
        return sum(1 for r in self._requests.values()
                   if r.status in ("queued", "dispatched"))

    def queue_depth(self) -> int:
        """Admitted-but-undispatched requests across all SLO classes —
        the front tier's per-leaf placement signal."""
        return self._queue_depth()

    def admission_depths(self) -> Dict[str, int]:
        """Per-class admission queue depths (front-tier fleet view)."""
        return {c: len(q) for c, q in self._queues.items()}

    def drain(self, timeout: Optional[float] = None, poll: float = 0.005):
        """Pump until every admitted request resolves (done/failed/shed).
        Returns True on full drain, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.pending():
            self.pump()
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll)
        return True

    def shutdown(self):
        """Broadcast stop to every worker polling this namespace."""
        with deadline_guard("broadcast stop"):
            self._store.set(k_ctl(self._ns), pack({"stop": True}))
        for est in self._engines.values():
            if est.link is not None:
                est.link.close()

    # -- inspection ----------------------------------------------------------

    def status(self, rid: int) -> str:
        return self._requests[rid].status

    def result(self, rid: int) -> np.ndarray:
        req = self._requests[rid]
        if req.status == "done":
            return req.tokens
        if req.status == "shed":
            raise RuntimeError(
                f"request {rid} was shed ({req.shed_reason}); "
                f"slo={req.slo}")
        if req.status == "failed":
            raise RuntimeError(f"request {rid} failed on {req.engine}: "
                               f"{req.error}")
        raise RuntimeError(f"request {rid} not finished (status "
                           f"{req.status!r}); pump() the router")

    def latencies(self) -> Dict[str, List[float]]:
        """submit->finish seconds of completed requests, per SLO class."""
        out: Dict[str, List[float]] = {c: [] for c in SLO_CLASSES}
        for req in self._requests.values():
            if req.status == "done" and req.finish_t is not None:
                out[req.slo].append(req.finish_t - req.submit_t)
        return out

    def stats(self) -> dict:
        return {**self.counters,
                "queue_depth": self._queue_depth(),
                "engines_alive": self._alive_count(),
                "engines_known": self._known_engines}
