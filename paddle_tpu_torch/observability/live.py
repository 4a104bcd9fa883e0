"""Live telemetry plane (counterpart of
``paddle_tpu/observability/live.py``: plain Python, kept as the port's own
copy) — streaming aggregation over the existing sinks.

The metrics registry, the JSONL events and the span traces are post-hoc:
per-rank files that a report merges after the run. This module turns them
into a LIVE signal without adding a second instrumentation path:

* ``LiveShipper`` (every rank / serving worker) **tails the same sinks
  the other pillars already write** — the span stream via
  ``tracing.SpanTailer`` (byte-offset resume, torn-tail safe) and the
  in-process registry for a whitelist of counters — and batches the
  deltas into seq-numbered payloads. Serving workers piggyback them as
  ``tele`` frames on the streaming transport's heartbeat cadence; a
  short ring of recent payloads is re-sent on every beat so a frame lost
  to a severed connection is healed by the next beat, and the receiver
  dedups by (source, seq) *and* by span id.
* ``LiveAggregator`` (router / rank 0) assembles shipped + locally
  tailed spans into sliding-window per-SLO-class latency and phase
  histograms (fixed-boundary **mergeable** histograms, so windows and
  sources combine by vector addition), computes p50/p95/p99 and
  error-budget burn rates against the declared objectives in
  ``serving/protocol.SLO_OBJECTIVES`` (via ``tracing.compute_burn`` —
  the same formula the post-hoc summary uses, so live and batch numbers
  are definitionally comparable), tracks per-rank step-time EWMA
  straggler z-scores and per-MPMD-stage busy/idle imbalance, and
  periodically writes an atomic ``fleet_health.json`` — the
  machine-readable signal the fleet supervisor
  (``distributed/fleet/supervisor.py``) consumes — plus ``slo_burn`` /
  ``rank_straggler`` / ``stage_imbalance`` events into the normal event
  log.

Governance: the ``live_*`` metric family and the ``slo_*`` metric+event
families are **single-writer, owned by this file** (``catalog.py``);
every SLO class name in this plane is a literal present in
``protocol.SLO_CLASSES``.

Failure posture: the live plane is advisory. Shipping is fire-and-forget
on the existing transport links (every socket op stays under the
sender's ``deadline_guard`` discipline), ingest never throws past the
frame pump, and on transport loss the plane silently degrades to the
file-based pillars — it must never block or fail the request path.

Everything is env-gated **off by default**: set
``PADDLE_TPU_LIVE_TELEMETRY=1`` (in addition to
``PADDLE_TPU_TELEMETRY_DIR``) to enable. Disabled, every entry point
returns after one ``os.environ`` dict lookup.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import observability as _obs
from . import accounting as _acct
from . import tracing

__all__ = [
    "live_enabled", "MergeableHistogram", "LiveShipper", "LiveAggregator",
    "note_stage_stats", "stage_stats", "collect_counters",
]

#: counters worth streaming fleet-wide (absolute values — idempotent
#: under redundant re-sends, so dedup needs no delta reconstruction)
SHIP_COUNTERS = (
    "serving_transport_reconnect_total",
    "compile_cache_hits_total",
    "compile_cache_miss_total",
    "serving_router_failover_total",
)

_FALSEY = ("", "0", "false", "no", "off")


def live_enabled() -> bool:
    """True when the live plane is on. The first check is a single
    ``os.environ`` dict lookup so the disabled path stays ~µs."""
    flag = os.environ.get("PADDLE_TPU_LIVE_TELEMETRY")
    if not flag or flag.lower() in _FALSEY:
        return False
    return bool(os.environ.get("PADDLE_TPU_TELEMETRY_DIR"))


# ---------------------------------------------------------------------------
# fixed-boundary mergeable histogram
# ---------------------------------------------------------------------------
#: geometric bucket ladder: 100µs … ~20min, 4% growth. All instances
#: share these boundaries, so merge = vector addition and the quantile
#: estimate is within ONE bucket width (≤4% relative) of the exact
#: order statistic — the property the ±5% live-vs-post-hoc
#: reconciliation budget rests on (tests pin the error bound).
_B0 = 1e-4
_GROWTH = 1.04
_NGEO = 420
_LOG_G = math.log(_GROWTH)

#: bucket i covers [BOUNDS[i], BOUNDS[i+1]); bucket 0 is [0, _B0),
#: the last bucket absorbs overflow.
BOUNDS = [0.0] + [_B0 * _GROWTH ** i for i in range(_NGEO + 1)]


def _bucket_index(v: float) -> int:
    if v < _B0:
        return 0
    # past the ladder's top (~23 min) the last bucket absorbs the value;
    # the reference indexes past BOUNDS there (ROADMAP.md §C.36)
    i = min(int(math.log(v / _B0) / _LOG_G) + 1, len(BOUNDS) - 1)
    # float-log edge safety: land exactly on the bucket containing v
    while i < len(BOUNDS) - 1 and v >= BOUNDS[i + 1]:
        i += 1
    while i > 0 and v < BOUNDS[i]:
        i -= 1
    return min(i, len(BOUNDS) - 1)


class MergeableHistogram:
    """Counts over the shared fixed ladder; O(1) add, merge by addition.

    Unlike the registry's reservoir histograms (bounded recent samples),
    this never forgets within its lifetime and two instances from
    different ranks/windows combine losslessly — the shape sliding-window
    fleet aggregation needs."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, v: float) -> None:
        v = float(v)
        b = _bucket_index(v)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "MergeableHistogram") -> None:
        for b, c in other.counts.items():
            self.counts[b] = self.counts.get(b, 0) + c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def quantile(self, q: float) -> float:
        """Interpolated quantile matching ``tracing._pct``'s nearest-rank
        convention: the estimate lies inside the bucket holding the exact
        rank-``round(q*(n-1))`` order statistic, so the error is bounded
        by that bucket's width."""
        if self.count == 0:
            return 0.0
        target = int(round(q * (self.count - 1)))
        seen = 0
        for b in sorted(self.counts):
            c = self.counts[b]
            if seen + c > target:
                lo = BOUNDS[b]
                hi = BOUNDS[b + 1] if b + 1 < len(BOUNDS) else self.max
                if math.isfinite(self.min):
                    lo = max(lo, min(self.min, hi))
                if math.isfinite(self.max):
                    hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (target - seen + 0.5) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.max if math.isfinite(self.max) else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


# ---------------------------------------------------------------------------
# MPMD stage-stats export (fed by distributed/mpmd.py once per step)
# ---------------------------------------------------------------------------
_stage_lock = threading.Lock()
_stage_stats: Dict[str, dict] = {}


def note_stage_stats(stats: Dict[str, dict]) -> None:
    """Record this process's latest per-stage busy/idle stats (the MPMD
    executor's ``last_step_stats``). One env lookup when the plane is
    off; shippers and the local aggregator read the latest value — the
    live plane wants the current bubble, not a history."""
    if not live_enabled():
        return
    with _stage_lock:
        _stage_stats.clear()
        for s, rec in stats.items():
            _stage_stats[str(s)] = {
                "busy_s": round(float(rec.get("busy_s", 0.0)), 6),
                "wall_s": round(float(rec.get("wall_s", 0.0)), 6),
                "idle_fraction": round(float(rec.get("idle_fraction", 0.0)),
                                       6),
            }


def stage_stats() -> Dict[str, dict]:
    with _stage_lock:
        return {s: dict(rec) for s, rec in _stage_stats.items()}


def collect_counters() -> Dict[str, float]:
    """Whitelisted counter totals from the local registry (labels
    summed) — the non-span payload of a tele frame."""
    out: Dict[str, float] = {}
    reg = _obs.registry()
    for name in SHIP_COUNTERS:
        m = reg.get(name)
        if m is None:
            continue
        try:
            snap = m.snapshot()
        except Exception:
            continue
        vals = snap.get("values", {})
        total = sum(v for v in vals.values() if isinstance(v, (int, float)))
        if total:
            out[name] = total
    return out


# ---------------------------------------------------------------------------
# shipper
# ---------------------------------------------------------------------------
class LiveShipper:
    """Batches telemetry deltas from the existing sinks into seq-numbered
    payloads for the ``tele`` frame.

    No second instrumentation path: spans come from tailing this rank's
    ``spans_rank{R}.jsonl`` (the same file the tracing sink appends),
    counters from the live registry, stage stats from the MPMD export
    hook. ``collect()`` returns the payload batch to piggyback on the
    next heartbeat — a ring of the most recent payloads, so each payload
    rides ~``redundancy`` consecutive beats and a dropped frame is
    healed by the next one (the aggregator dedups)."""

    def __init__(self, source: str, interval_s: float = 0.5,
                 redundancy: int = 3, max_spans: int = 2000,
                 ledger_fn: Optional[Callable] = None):
        self.source = str(source)
        self.interval_s = float(interval_s)
        self.max_spans = int(max_spans)
        #: optional zero-arg callable returning this process's tenant
        #: ledger (accounting.TenantLedger) or None; its drained deltas
        #: ride the payload under the same (src, seq) exactly-once dedup
        self.ledger_fn = ledger_fn
        self._seq = 0
        self._last = 0.0
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(redundancy), 1))
        self._resend_left = 0
        self._tailer: Optional[tracing.SpanTailer] = None
        self._tail_path: Optional[str] = None
        self._sent_counters: Dict[str, float] = {}
        self._sent_stages: Dict[str, dict] = {}

    def _span_tailer(self) -> Optional[tracing.SpanTailer]:
        d = _obs.telemetry_dir()
        if d is None:
            return None
        path = os.path.join(d, f"spans_rank{_obs.rank()}.jsonl")
        if self._tailer is None or self._tail_path != path:
            self._tailer = tracing.SpanTailer(path)
            self._tail_path = path
        return self._tailer

    def collect(self, now: Optional[float] = None) -> Optional[List[dict]]:
        """The payload batch to ship on this beat, or None when the
        plane is off / the interval has not elapsed / there is nothing
        new and the ring has drained its redundancy budget. Never
        raises — shipping is advisory."""
        if not live_enabled():
            return None
        try:
            return self._collect(time.time() if now is None else now)
        except Exception:
            return None  # a tail/registry hiccup must not hurt the caller

    def _collect(self, now: float) -> Optional[List[dict]]:
        if now - self._last < self.interval_s:
            return None
        self._last = now
        spans: List[dict] = []
        tailer = self._span_tailer()
        if tailer is not None:
            spans = tailer.poll()
            if len(spans) > self.max_spans:
                spans = spans[-self.max_spans:]
        counters = collect_counters()
        stages = stage_stats()
        tenants = None
        if self.ledger_fn is not None:
            led = self.ledger_fn()
            if led is not None:
                tenants = led.collect_delta()
        fresh = (spans or tenants or counters != self._sent_counters
                 or stages != self._sent_stages)
        if fresh:
            self._seq += 1
            payload = {
                "v": 1,
                "src": self.source,
                "rank": _obs.rank(),
                "seq": self._seq,
                "ts": round(now, 6),
                "spans": spans,
                "counters": counters,
            }
            if stages:
                payload["stages"] = stages
            if tenants:
                payload["tenants"] = tenants
            self._sent_counters = counters
            self._sent_stages = stages
            self._ring.append(payload)
            self._resend_left = self._ring.maxlen
            _obs.inc("live_ship_batches_total")
            if spans:
                _obs.inc("live_ship_spans_total", len(spans))
        elif self._resend_left <= 0 or not self._ring:
            return None
        self._resend_left -= 1
        return list(self._ring)


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------
def _objectives_default() -> dict:
    from ..serving import protocol  # lazy: keep import-time deps one-way

    return protocol.SLO_OBJECTIVES


class _ClassWindow:
    """One SLO class's stats inside one sub-window bucket."""

    __slots__ = ("lat", "phases", "total", "over", "shed", "failed")

    def __init__(self):
        self.lat = MergeableHistogram()
        self.phases: Dict[str, MergeableHistogram] = {}
        self.total = 0
        self.over = 0
        self.shed = 0
        self.failed = 0


class LiveAggregator:
    """Router/rank-0 side of the live plane: ingest payloads (wire) and
    locally tailed spans (shared telemetry dir), maintain sliding-window
    per-class latency/phase histograms + burn rates + straggler z-scores
    + stage imbalance, and periodically write ``fleet_health.json``.

    Dedup is two-level: payloads by (source, seq) — redundant re-sends
    and retransmits collapse — and spans by span id, so a span that
    arrives both over the wire and via a local tail of the shared
    telemetry dir is still counted exactly once."""

    def __init__(self, objectives: Optional[dict] = None,
                 window_s: float = 60.0, bucket_s: float = 5.0,
                 straggler_z: float = 3.0, ewma_alpha: float = 0.2,
                 stage_imbalance_threshold: float = 0.25,
                 health_interval_s: float = 2.0,
                 event_cooldown_s: float = 10.0,
                 reconnect_storm_per_min: float = 30.0,
                 tail_local: bool = True,
                 burn_event_threshold: float = 1.0,
                 heavy_hitter_k: int = 8,
                 heavy_hitter_share: float = 0.25):
        self.objectives = (dict(objectives) if objectives is not None
                           else dict(_objectives_default()))
        self.window_s = float(window_s)
        self.bucket_s = float(bucket_s)
        self.straggler_z = float(straggler_z)
        self.ewma_alpha = float(ewma_alpha)
        self.stage_imbalance_threshold = float(stage_imbalance_threshold)
        self.health_interval_s = float(health_interval_s)
        self.event_cooldown_s = float(event_cooldown_s)
        self.reconnect_storm_per_min = float(reconnect_storm_per_min)
        self.burn_event_threshold = float(burn_event_threshold)
        self.heavy_hitter_k = int(heavy_hitter_k)
        self.heavy_hitter_share = float(heavy_hitter_share)
        self._tail_local = bool(tail_local)

        self._lock = threading.Lock()
        self._seen_seq: Dict[str, int] = {}
        self._seen_spans: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._windows: Dict[int, Dict[str, _ClassWindow]] = {}
        # trace assembly: phases arrive before (or after) their root
        self._pending: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._trace_cls: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._step_ewma: Dict[int, float] = {}
        self._step_n: Dict[int, int] = {}
        self._stages: Dict[str, Dict[str, dict]] = {}  # src -> stage -> rec
        self._counters: Dict[str, Dict[str, float]] = {}  # src -> name -> v
        self._reconnect_hist: collections.deque = collections.deque(maxlen=64)
        self._queues: dict = {}
        self._tailers: Dict[str, tracing.SpanTailer] = {}
        self._last_health = 0.0
        self._last_event: Dict[str, float] = {}
        self._sources: Dict[str, float] = {}
        # tenant attribution plane: fleet ledger (merged from shipped +
        # router-fed deltas, each exactly once), heavy-hitter sketch over
        # priced device-second increments, windowed per-(tenant, slo)
        # burn counters, and the router's outstanding-token feed
        self._tenant_ledger = _acct.TenantLedger()
        self._tenant_sketch = _acct.SpaceSavingSketch(capacity=64)
        self._tenant_prices: Optional[_acct.Prices] = None
        self._tenant_outstanding: Dict[str, Dict[str, float]] = {}
        self._tenant_win: Dict[int, Dict[Tuple[str, str], List[int]]] = {}
        # front-tier fleet view (note_frontier); None = no front tier
        self._frontier: Optional[dict] = None

    # -- ingest ------------------------------------------------------------
    def ingest(self, payload: dict, now: Optional[float] = None) -> bool:
        """One shipped payload (dict with src/seq/spans/counters/stages).
        Returns False for duplicates/stale seqs. Never raises past a
        malformed payload — the frame pump must not die on telemetry."""
        if not isinstance(payload, dict):
            return False
        now = time.time() if now is None else now
        src = str(payload.get("src", "?"))
        try:
            seq = int(payload.get("seq", 0))
        except (TypeError, ValueError):
            return False
        with self._lock:
            last = self._seen_seq.get(src, 0)
            if seq <= last:
                _obs.inc("live_ingest_dup_total")
                return False
            self._seen_seq[src] = seq
            self._sources[src] = now
            counters = payload.get("counters")
            if isinstance(counters, dict):
                dst = self._counters.setdefault(src, {})
                for name, v in counters.items():
                    if isinstance(v, (int, float)):
                        dst[str(name)] = float(v)
            stages = payload.get("stages")
            if isinstance(stages, dict):
                self._stages[src] = {
                    str(s): dict(rec) for s, rec in stages.items()
                    if isinstance(rec, dict)}
            tenants = payload.get("tenants")
            if isinstance(tenants, dict) and tenants:
                try:
                    self._adopt_tenants(tenants)
                except Exception:
                    pass  # advisory: malformed delta must not kill the pump
        spans = payload.get("spans")
        if isinstance(spans, list) and spans:
            self.ingest_spans(spans, now=now)
        _obs.inc("live_ingest_total")
        return True

    def ingest_spans(self, spans: List[dict],
                     now: Optional[float] = None) -> int:
        """Feed span records (wire-shipped or locally tailed) into the
        windowed stats; returns how many were new. Thread-safe."""
        now = time.time() if now is None else now
        fresh = 0
        with self._lock:
            for rec in spans:
                if not isinstance(rec, dict):
                    continue
                sid = rec.get("span_id")
                if sid is not None:
                    if sid in self._seen_spans:
                        continue
                    self._seen_spans[sid] = None
                    while len(self._seen_spans) > 200_000:
                        self._seen_spans.popitem(last=False)
                fresh += 1
                self._ingest_one(rec, now)
        return fresh

    def _epoch(self, now: float) -> int:
        return int(now // self.bucket_s)

    def _cls_window(self, slo: str, now: float) -> _ClassWindow:
        ep = self._windows.setdefault(self._epoch(now), {})
        cw = ep.get(slo)
        if cw is None:
            cw = ep[slo] = _ClassWindow()
        return cw

    def _tenant_window(self, tenant: str, slo: str, now: float) -> List[int]:
        """[total, over_target, shed_or_failed] counters for one
        (tenant, slo) pair in the current sub-window bucket; bounded by
        folding excess tenants into the overflow cell."""
        ep = self._tenant_win.setdefault(self._epoch(now), {})
        key = (tenant, slo)
        tw = ep.get(key)
        if tw is None and len(ep) >= 1024:
            key = (_acct.OVERFLOW_TENANT, slo)
            tw = ep.get(key)
        if tw is None:
            tw = ep[key] = [0, 0, 0]
        return tw

    def _ingest_one(self, rec: dict, now: float) -> None:
        name = rec.get("name")
        dur = float(rec.get("dur_s", 0.0) or 0.0)
        if name == "train_step":
            try:
                r = int(rec.get("rank", 0))
            except (TypeError, ValueError):
                r = 0
            prev = self._step_ewma.get(r)
            a = self.ewma_alpha
            self._step_ewma[r] = dur if prev is None else \
                (1.0 - a) * prev + a * dur
            self._step_n[r] = self._step_n.get(r, 0) + 1
            return
        tid = rec.get("trace_id")
        if name == "srv_request" and not rec.get("parent_id"):
            attrs = rec.get("attrs") or {}
            slo = str(attrs.get("slo", "unknown"))
            status = attrs.get("status")
            cw = self._cls_window(slo, now)
            over = False
            bad = status in ("shed", "failed")
            cw.total += 1
            if status == "shed":
                cw.shed += 1
            elif status in ("done", "failed"):
                if status == "failed":
                    cw.failed += 1
                if dur > 0.0:
                    cw.lat.add(dur)
                    obj = self.objectives.get(slo)
                    if obj and dur > float(obj.get("latency_target_s", 0.0)):
                        cw.over += 1
                        over = True
            tenant = attrs.get("tenant")
            if tenant:
                tw = self._tenant_window(str(tenant), slo, now)
                tw[0] += 1
                tw[1] += int(over)
                tw[2] += int(bad)
            if tid:
                self._trace_cls[tid] = slo
                while len(self._trace_cls) > 50_000:
                    self._trace_cls.popitem(last=False)
                pend = self._pending.pop(tid, None)
                if pend:
                    for phase, pdur in pend["phases"]:
                        ph = cw.phases.setdefault(phase,
                                                  MergeableHistogram())
                        ph.add(pdur)
            return
        phase = tracing.PHASE_OF.get(name)
        if phase is None or not tid:
            return
        slo = self._trace_cls.get(tid)
        if slo is not None:
            cw = self._cls_window(slo, now)
            ph = cw.phases.setdefault(phase, MergeableHistogram())
            ph.add(dur)
            return
        pend = self._pending.get(tid)
        if pend is None:
            pend = self._pending[tid] = {"ts": now, "phases": []}
            while len(self._pending) > 10_000:
                self._pending.popitem(last=False)
        pend["phases"].append((phase, dur))

    def _adopt_tenants(self, wire: dict) -> None:
        """Fold one drained ledger delta (collect_delta wire form) into
        the fleet ledger and offer its priced device-second increment to
        the heavy-hitter sketch.  Callers sit behind the (src, seq)
        dedup (wire) or drain their own ledger (router feed), so each
        delta is adopted exactly once — conservation holds end to end.
        Must be called under ``self._lock``."""
        self._tenant_ledger.merge_wire(wire)
        if self._tenant_prices is None:
            self._tenant_prices = _acct.default_prices()
        inc: Dict[str, float] = {}
        for key, fields in wire.items():
            tenant = str(key).partition("|")[0] or _acct.DEFAULT_TENANT
            ds = self._tenant_prices.device_seconds(fields)
            if ds > 0.0:
                inc[tenant] = inc.get(tenant, 0.0) + ds
        for tenant in sorted(inc):
            self._tenant_sketch.offer(tenant, inc[tenant])

    # -- local feeds -------------------------------------------------------
    def note_queues(self, queues: dict) -> None:
        """Router-supplied queue depths for the health doc (per-class
        admission queues, per-engine outstanding tokens)."""
        with self._lock:
            self._queues = dict(queues)

    def note_tenants(self, delta: Optional[dict],
                     per_engine: Optional[Dict[str, Dict[str, float]]] = None
                     ) -> None:
        """Router-supplied in-process feed: its own drained ledger delta
        (shed attribution — wire form, may be None) and the per-engine
        per-tenant outstanding-token map.  Mirrors :meth:`note_queues`;
        the adoption path is the same one wire-shipped deltas take."""
        with self._lock:
            if isinstance(delta, dict) and delta:
                try:
                    self._adopt_tenants(delta)
                except Exception:
                    pass
            if per_engine is not None:
                self._tenant_outstanding = {
                    str(e): dict(by) for e, by in per_engine.items()}

    def note_frontier(self, view: Optional[dict]) -> None:
        """Front-tier feed (serving/frontier.py): the merged per-leaf
        fleet view — leaf queue depths, quota/throttle totals, hot
        tenants. Lands verbatim as the health doc's ``frontier`` block;
        absent when no front tier runs, so every existing consumer
        (supervisor included) is untouched."""
        with self._lock:
            self._frontier = dict(view) if view else None

    def heavy_hitters(self, k: int = 8) -> List[Tuple[str, float]]:
        """Ranked (tenant, share-of-priced-device-seconds) rows off the
        sketch — the same ranking the health doc's ``tenants.top`` block
        carries, exposed directly so the front tier's hot-tenant
        rebalance can poll it without assembling a full health doc."""
        with self._lock:
            total = self._tenant_sketch.total
            if total <= 0:
                return []
            return [(t, c / total)
                    for t, c, _ in self._tenant_sketch.topk(k)]

    def _poll_local(self, now: float) -> None:
        if not self._tail_local:
            return
        d = _obs.telemetry_dir()
        if d is None:
            return
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return
        for fn in names:
            if not (fn.startswith("spans_rank") and fn.endswith(".jsonl")):
                continue
            path = os.path.join(d, fn)
            t = self._tailers.get(path)
            if t is None:
                t = self._tailers[path] = tracing.SpanTailer(path)
            spans = t.poll()
            if spans:
                self.ingest_spans(spans, now=now)
        stages = stage_stats()
        if stages:
            with self._lock:
                self._stages["local"] = stages
        counters = collect_counters()
        if counters:
            with self._lock:
                self._counters["local"] = counters

    # -- windows / health --------------------------------------------------
    def _merged_classes(self, now: float) -> Dict[str, _ClassWindow]:
        lo = self._epoch(now - self.window_s)
        for ep in [e for e in self._windows if e < lo]:
            del self._windows[ep]
        out: Dict[str, _ClassWindow] = {}
        for ep, classes in self._windows.items():
            if ep < lo:
                continue
            for slo, cw in classes.items():
                dst = out.get(slo)
                if dst is None:
                    dst = out[slo] = _ClassWindow()
                dst.lat.merge(cw.lat)
                dst.total += cw.total
                dst.over += cw.over
                dst.shed += cw.shed
                dst.failed += cw.failed
                for p, h in cw.phases.items():
                    dst.phases.setdefault(
                        p, MergeableHistogram()).merge(h)
        return out

    def _merged_tenant_burn(self, now: float) -> Dict[str, Dict[str, float]]:
        """tenant -> slo -> that tenant's share of the class's windowed
        error-budget burn events (over-target completions plus shed /
        failed requests, over the class total across tenants).  Shares
        within one class sum to 1 whenever any burn events exist.
        Must be called under ``self._lock``."""
        lo = self._epoch(now - self.window_s)
        for ep in [e for e in self._tenant_win if e < lo]:
            del self._tenant_win[ep]
        merged: Dict[Tuple[str, str], List[int]] = {}
        for ep, cells in self._tenant_win.items():
            if ep < lo:
                continue
            for key, tw in cells.items():
                dst = merged.setdefault(key, [0, 0, 0])
                dst[0] += tw[0]
                dst[1] += tw[1]
                dst[2] += tw[2]
        denom: Dict[str, int] = {}
        for (_tenant, slo), tw in merged.items():
            denom[slo] = denom.get(slo, 0) + tw[1] + tw[2]
        out: Dict[str, Dict[str, float]] = {}
        for (tenant, slo) in sorted(merged):
            tw = merged[(tenant, slo)]
            d = denom.get(slo, 0)
            out.setdefault(tenant, {})[slo] = (
                round((tw[1] + tw[2]) / d, 6) if d else 0.0)
        return out

    def _tenants_doc(self, now: float) -> dict:
        """The health doc's ``tenants`` block: exact per-tenant usage
        (conservation table), ranked heavy-hitter rows, fleet totals,
        prices.  Additive — existing supervisor reads are untouched.
        Must be called under ``self._lock``."""
        led = self._tenant_ledger
        prices = self._tenant_prices
        if prices is None:
            prices = self._tenant_prices = _acct.default_prices()
        burn = self._merged_tenant_burn(now)
        per_tenant = led.per_tenant()
        fleet = led.fleet()
        exact = {}
        for tenant, cell in per_tenant.items():
            exact[tenant] = {
                **{f: cell[f] for f in _acct.INT_FIELDS},
                "queue_seconds": round(cell["queue_seconds"], 6),
                "device_seconds": round(prices.device_seconds(cell), 9),
            }
        rows = []
        for rank, (tenant, count, err) in enumerate(
                self._tenant_sketch.topk(self.heavy_hitter_k)):
            cell = per_tenant.get(tenant)
            row = {
                "tenant": tenant,
                "rank": rank,
                "device_seconds": (round(prices.device_seconds(cell), 9)
                                   if cell else round(count, 9)),
                "sketch_count": round(count, 9),
                "sketch_error": round(err, 9),
            }
            if cell:
                row["requests"] = cell["requests"]
                row["shed_requests"] = cell["shed_requests"]
                row["prefill_tokens"] = cell["prefill_tokens"]
                row["decode_tokens"] = cell["decode_tokens"]
                row["spec_wasted_tokens"] = cell["spec_wasted_tokens"]
                row["kv_page_seconds"] = round(cell["kv_page_us"] * 1e-6, 6)
                row["wire_bytes"] = cell["wire_bytes"]
            bs = burn.get(tenant)
            if bs:
                row["burn_share"] = bs
            outst = {e: by[tenant]
                     for e, by in sorted(self._tenant_outstanding.items())
                     if tenant in by}
            if outst:
                row["outstanding_tokens"] = outst
            rows.append(row)
        return {
            "fleet": {
                **{f: fleet[f] for f in _acct.INT_FIELDS},
                "queue_seconds": round(fleet["queue_seconds"], 6),
                "device_seconds": round(prices.device_seconds(fleet), 9),
            },
            "per_tenant": exact,
            "top": rows,
            "tracked": len(led),
            "folded_tenants": led.folded_tenants,
            "sketch": {"capacity": self._tenant_sketch.capacity,
                       "total": round(self._tenant_sketch.total, 9)},
            "prices": prices.to_dict(),
        }

    def _stragglers(self) -> List[dict]:
        ew = {r: v for r, v in self._step_ewma.items()
              if self._step_n.get(r, 0) >= 3}
        out = []
        if len(ew) >= 2:
            vals = list(ew.values())
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / len(vals)
            std = math.sqrt(var)
            for r, v in sorted(ew.items()):
                z = (v - mean) / std if std > 1e-12 else 0.0
                rec = {"rank": r, "ewma_step_seconds": round(v, 6),
                       "z": round(z, 3),
                       "flagged": bool(z > self.straggler_z
                                       and v > mean * 1.05)}
                out.append(rec)
        return out

    def _stage_imbalance(self) -> dict:
        idle: Dict[str, List[float]] = {}
        for recs in self._stages.values():
            for s, rec in recs.items():
                try:
                    idle.setdefault(s, []).append(
                        float(rec.get("idle_fraction", 0.0)))
                except (TypeError, ValueError):
                    continue
        if not idle:
            return {}
        per_stage = {s: round(sum(v) / len(v), 6)
                     for s, v in sorted(idle.items())}
        spread = round(max(per_stage.values()) - min(per_stage.values()), 6)
        return {"idle_fraction": per_stage, "imbalance": spread,
                "flagged": bool(spread > self.stage_imbalance_threshold
                                and len(per_stage) >= 2)}

    def _transport_health(self, now: float) -> dict:
        total = 0.0
        for counters in self._counters.values():
            total += counters.get("serving_transport_reconnect_total", 0.0)
        self._reconnect_hist.append((now, total))
        rate = 0.0
        horizon = now - self.window_s
        base = None
        for ts, v in self._reconnect_hist:
            if ts >= horizon:
                base = (ts, v)
                break
        if base is not None and now - base[0] > 1e-6:
            rate = (total - base[1]) / (now - base[0]) * 60.0
        return {"reconnect_total": total,
                "reconnect_rate_per_min": round(max(rate, 0.0), 3),
                "storm": bool(rate > self.reconnect_storm_per_min)}

    def _compile_cache_health(self) -> dict:
        hits = misses = 0.0
        for counters in self._counters.values():
            hits += counters.get("compile_cache_hits_total", 0.0)
            misses += counters.get("compile_cache_miss_total", 0.0)
        lookups = hits + misses
        return {"hits": hits, "misses": misses,
                "hit_rate": round(hits / lookups, 6) if lookups else None}

    def health(self, now: Optional[float] = None) -> dict:
        """The current fleet-health document (the ``fleet_health.json``
        body): windowed per-class latency quantiles + burn rates,
        straggler z-scores, stage imbalance, queue depths, transport
        reconnect storms, compile-cache hit rate."""
        now = time.time() if now is None else now
        with self._lock:
            classes = self._merged_classes(now)
            # expire stale pending traces (roots that never closed)
            horizon = now - 2.0 * self.window_s
            while self._pending:
                tid, pend = next(iter(self._pending.items()))
                if pend["ts"] >= horizon:
                    break
                del self._pending[tid]
            doc_classes = {}
            for slo, cw in sorted(classes.items()):
                admitted = cw.total
                completed = cw.lat.count
                bad = cw.shed + cw.failed
                entry = {
                    "requests": completed,
                    "admitted": admitted,
                    "shed": cw.shed,
                    "failed": cw.failed,
                    "latency_seconds": {
                        "p50": round(cw.lat.quantile(0.50), 6),
                        "p95": round(cw.lat.quantile(0.95), 6),
                        "p99": round(cw.lat.quantile(0.99), 6),
                        "mean": round(cw.lat.mean, 6),
                    },
                    "phase_seconds_p95": {
                        p: round(h.quantile(0.95), 6)
                        for p, h in sorted(cw.phases.items())},
                }
                obj = self.objectives.get(slo)
                if obj:
                    entry["objectives"] = tracing.compute_burn(
                        completed, cw.over, bad, admitted, obj)
                doc_classes[slo] = entry
            doc = {
                "schema": 1,
                "ts": round(now, 6),
                "window_s": self.window_s,
                "classes": doc_classes,
                "stragglers": self._stragglers(),
                "stages": self._stage_imbalance(),
                "queues": dict(self._queues),
                "transport": self._transport_health(now),
                "compile_cache": self._compile_cache_health(),
                "sources": {s: round(now - ts, 3)
                            for s, ts in sorted(self._sources.items())},
                "tenants": self._tenants_doc(now),
            }
            if self._frontier is not None:
                doc["frontier"] = dict(self._frontier)
        return doc

    def write_health(self, doc: Optional[dict] = None,
                     now: Optional[float] = None) -> Optional[str]:
        """Atomic (tmp + rename) write of ``fleet_health.json`` under the
        telemetry dir; returns the path, or None when telemetry is off."""
        d = _obs.telemetry_dir()
        if d is None:
            return None
        if doc is None:
            doc = self.health(now)
        path = os.path.join(d, "fleet_health.json")
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            return None
        _obs.inc("live_health_writes_total")
        return path

    def _maybe_event(self, key: str, now: float) -> bool:
        last = self._last_event.get(key, 0.0)
        if now - last < self.event_cooldown_s:
            return False
        self._last_event[key] = now
        return True

    def _emit_signals(self, doc: dict, now: float) -> None:
        for slo, entry in doc["classes"].items():
            obj = entry.get("objectives")
            if not obj:
                continue
            _obs.set_gauge("live_window_requests", entry["requests"],
                           slo=slo)
            _obs.set_gauge("slo_burn_rate", obj["burn_rate_latency"],
                           slo=slo, objective="latency")
            _obs.set_gauge("slo_burn_rate", obj["burn_rate_availability"],
                           slo=slo, objective="availability")
            for which in ("latency", "availability"):
                burn = obj[f"burn_rate_{which}"]
                if burn > self.burn_event_threshold and \
                        self._maybe_event(f"burn/{slo}/{which}", now):
                    _obs.event("slo_burn", slo=slo, objective=which,
                               burn_rate=round(burn, 3),
                               window_s=self.window_s,
                               requests=entry["requests"])
        for rec in doc["stragglers"]:
            if rec.get("flagged") and \
                    self._maybe_event(f"straggler/{rec['rank']}", now):
                _obs.event("rank_straggler", rank=rec["rank"],
                           z=rec["z"],
                           ewma_step_seconds=rec["ewma_step_seconds"])
        st = doc["stages"]
        if st.get("flagged") and self._maybe_event("stage_imbalance", now):
            _obs.event("stage_imbalance",
                       imbalance=st["imbalance"],
                       idle_fraction=st["idle_fraction"])
        tn = doc.get("tenants")
        if tn and (tn["top"] or self._tenant_outstanding):
            with self._lock:
                _acct.publish_tenant_gauges(self._tenant_ledger,
                                            self._tenant_prices)
                _acct.publish_outstanding(self._tenant_outstanding)
            fleet_ds = tn["fleet"]["device_seconds"]
            for row in tn["top"]:
                tenant = row["tenant"]
                if tenant in (_acct.DEFAULT_TENANT, _acct.OVERFLOW_TENANT):
                    continue  # untenanted / folded usage is not actionable
                share = (row["device_seconds"] / fleet_ds
                         if fleet_ds > 0.0 else 0.0)
                if share >= self.heavy_hitter_share and \
                        self._maybe_event(f"tenant/{tenant}", now):
                    _acct.emit_heavy_hitter(
                        tenant, row["device_seconds"], row["rank"],
                        round(share, 6), self.window_s)

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One aggregation round: poll local tails, roll windows, and —
        at the health cadence — write ``fleet_health.json``, refresh the
        ``live_*``/``slo_*`` gauges, and emit threshold events. Cheap
        between cadences; returns the health doc when one was written."""
        if not live_enabled():
            return None
        now = time.time() if now is None else now
        try:
            self._poll_local(now)
            if now - self._last_health < self.health_interval_s:
                return None
            self._last_health = now
            doc = self.health(now)
            self.write_health(doc, now)
            self._emit_signals(doc, now)
            return doc
        except Exception:
            return None  # advisory plane: never propagate into the caller
