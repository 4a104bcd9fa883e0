"""Distributed request/step tracing — span trees over the telemetry sink
(counterpart of ``paddle_tpu/observability/tracing.py``, the same code and
the same span-file format, so the reference's report tools read the
port's files).

The third observability pillar next to metrics and flat events: a **span** is a named, timed interval with a
``trace_id`` (the tree it belongs to), a ``span_id``, and an optional
``parent_id``. One routed serving request yields exactly one tree across
three processes::

    srv_request (router)
      ├─ srv_admit / srv_queue / srv_dispatch      (router)
      ├─ srv_retry                                 (router; failover, retry=True)
      ├─ srv_net_transit / srv_drain               (worker; streaming
      │                                             dataplane — the store
      │                                             path emits
      │                                             srv_store_transit)
      ├─ srv_kv_stream                             (decode worker; only on
      │                                             disaggregated prefill)
      └─ srv_prefill / srv_decode ── srv_verify    (engine)

and the training side emits single-span trees per compile miss, train
step, checkpoint commit, reshard, pipeline-schedule build and gradient-
exchange build — all through the same three entry points:

* ``span(name, **attrs)`` — context manager; nested spans chain through a
  thread-local stack (child inherits trace_id, parent_id);
* ``start_span``/``end_span`` — explicit handles for intervals that cross
  function boundaries (the router holds a request's queue span open
  across pump() rounds);
* ``record_span`` — retroactive: the duration was measured elsewhere
  (engine phase accounting, checkpoint commit times).

Cross-process propagation is a plain dict (``{"trace_id", "parent_id",
"resubmits", "dispatch_ts"}``) carried inside the ``__srv`` wire record
(serving/protocol.py) next to the router-assigned seed; the worker and
engine continue the trace from it.

Discipline matches the event log exactly: everything is env-gated on
``PADDLE_TPU_TELEMETRY_DIR`` (re-read per call; the disabled path is one
dict lookup), and each finished span is ONE ``json.dumps`` line appended
open/append/close under a lock to ``spans_rank{R}.jsonl`` — O_APPEND
atomicity means concurrent writers interleave whole lines and a SIGKILL
never tears a flushed span (an *unfinished* span is simply lost, which is
the correct account of a killed process).

Timing: durations come from the monotonic ``time.perf_counter`` clock;
each record also carries a wall-clock start (``ts``) so per-process span
streams can be merged onto one Perfetto timeline (scripts/trace_report.py).
Cross-host wall skew shifts tracks, never durations. The cross-process
spans — ``srv_store_transit``/``srv_net_transit`` (dispatch transit) and
``srv_kv_stream`` (prefill->decode KV handoff) — are wall-to-wall by
necessity.

This module is dependency-free (stdlib only) and importable straight from
its file path — ``scripts/trace_report.py`` loads it the way
``scripts/check_observability.py`` loads catalog.py, so merging traces
never drags jax into a reporting CLI. Span NAMES are governed by
``catalog.SPANS`` and the extended static checker (single writer per
span name).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "span", "start_span", "end_span", "record_span", "new_trace_id",
    "load_spans", "summarize_spans", "summarize_dir", "validate_trees",
    "SpanTailer", "compute_burn",
]

_io_lock = threading.Lock()
_local = threading.local()

#: set by observability/__init__ to count recorded spans into the
#: registry (trace_spans_total); None keeps this module stdlib-standalone
_counter_hook = None

#: span name -> report phase for per-request latency attribution.
#: store_transit and net_transit are mutually exclusive per attempt (the
#: worker emits one or the other depending on which dataplane carried
#: the dispatch), so their SUM is the request's transit share.
PHASE_OF = {
    "srv_queue": "queue",
    "srv_store_transit": "store_transit",
    "srv_net_transit": "net_transit",
    "srv_kv_stream": "kv_stream",
    "srv_prefill": "prefill",
    "srv_decode": "decode",
    "srv_retry": "failover",
}
PHASES = ("queue", "store_transit", "net_transit", "prefill", "kv_stream",
          "decode", "failover", "other")


def _dir() -> Optional[str]:
    d = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    return d if d else None


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or "0")
    except ValueError:
        return 0


def new_trace_id() -> str:
    return os.urandom(8).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _NoopSpan:
    """Falsy stand-in returned by every entry point when telemetry is
    off: attribute reads give None, so call sites can thread
    ``handle.span_id`` into children without guarding."""
    __slots__ = ()
    name = None
    trace_id = None
    span_id = None
    parent_id = None

    def __bool__(self):
        return False


_NOOP = _NoopSpan()


class SpanHandle:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "_wall0")

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._wall0 = time.time()

    def __bool__(self):
        return True


def _write(name: str, trace_id: str, span_id: str,
           parent_id: Optional[str], wall_start: float, dur_s: float,
           attrs: dict) -> None:
    d = _dir()
    if d is None:
        return  # flipped off between start and end: drop, never block
    rec = {
        "kind": "span",
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "ts": round(wall_start, 6),
        "dur_s": round(max(float(dur_s), 0.0), 9),
        "rank": _rank(),
        "pid": os.getpid(),
    }
    if attrs:
        rec["attrs"] = attrs
    line = json.dumps(rec, default=str) + "\n"
    path = os.path.join(d, f"spans_rank{_rank()}.jsonl")
    with _io_lock:
        os.makedirs(d, exist_ok=True)
        # open/append/close per span: one O_APPEND write per line is
        # atomic across the router/worker processes sharing a rank file,
        # and nothing sits in a buffer when a SIGKILL lands
        with open(path, "a") as f:
            f.write(line)
    if _counter_hook is not None:
        _counter_hook(name)


def start_span(name: str, *, trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, **attrs):
    """Open a span and return its handle (``_NOOP`` when telemetry is
    off). With no explicit ``trace_id`` the innermost enclosing
    ``span(...)`` context supplies trace and parent; with neither, a
    fresh trace is minted (this span is a root). The caller owns the
    handle — nothing is written until ``end_span``."""
    if _dir() is None:
        return _NOOP
    if trace_id is None:
        st = _stack()
        if st:
            top = st[-1]
            trace_id = top.trace_id
            if parent_id is None:
                parent_id = top.span_id
        else:
            trace_id = new_trace_id()
    return SpanHandle(name, trace_id, parent_id, attrs)


def end_span(handle, **attrs) -> Optional[str]:
    """Close a handle from ``start_span``; extra attrs merge over the
    start-time ones. Returns the span id (None when it was a no-op)."""
    if not handle:
        return None
    if attrs:
        handle.attrs.update(attrs)
    _write(handle.name, handle.trace_id, handle.span_id,
           handle.parent_id, handle._wall0,
           time.perf_counter() - handle._t0, handle.attrs)
    return handle.span_id


def record_span(name: str, *, trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                start_ts: Optional[float] = None,
                end_ts: Optional[float] = None,
                dur_s: Optional[float] = None, **attrs) -> Optional[str]:
    """Record an already-measured span in one call. Give either
    ``dur_s`` (wall start is derived from ``end_ts`` minus it; default
    end is now) or an explicit ``start_ts`` wall clock (the
    cross-process ``srv_store_transit`` case). Returns the new span id
    so later spans can parent to it, or None when telemetry is off."""
    if _dir() is None:
        return None
    if end_ts is None:
        end_ts = time.time()
    if dur_s is None:
        dur_s = 0.0 if start_ts is None else max(end_ts - start_ts, 0.0)
    if start_ts is None:
        start_ts = end_ts - max(float(dur_s), 0.0)
    if trace_id is None:
        trace_id = new_trace_id()
    sid = _new_span_id()
    _write(name, trace_id, sid, parent_id, start_ts, dur_s, attrs)
    return sid


class span:
    """Context manager form; nests through the thread-local stack::

        with _obs.span("ckpt_save", step=n):
            ...

    ``trace_id``/``parent_id`` keyword arguments join an existing trace
    (they are reserved and never become attrs); all other keywords are
    span attributes. Disabled cost is one env lookup."""

    __slots__ = ("_name", "_kw", "_handle")

    def __init__(self, name: str, **kw):
        self._name = name
        self._kw = kw
        self._handle = None

    def __enter__(self):
        if _dir() is None:
            return _NOOP
        kw = self._kw
        self._handle = start_span(
            self._name, trace_id=kw.pop("trace_id", None),
            parent_id=kw.pop("parent_id", None), **kw)
        _stack().append(self._handle)
        return self._handle

    def __exit__(self, exc_type, exc, tb):
        h = self._handle
        if h is not None:
            st = _stack()
            if st and st[-1] is h:
                st.pop()
            if exc_type is not None:
                end_span(h, error=repr(exc))
            else:
                end_span(h)
            self._handle = None
        return False


# ---------------------------------------------------------------------------
# merge / report helpers (pure; shared by fleet.py rank-0 aggregation and
# scripts/trace_report.py — both stdlib-only consumers)
# ---------------------------------------------------------------------------

def load_spans(directory: str) -> List[dict]:
    """Every parseable span record from ``spans_rank*.jsonl`` under
    ``directory``. A torn final line (the writer was SIGKILLed between
    write and close — or mid-write on a non-O_APPEND filesystem) is
    skipped, not fatal: chaos kills must never break the report."""
    out: List[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fn in names:
        if not (fn.startswith("spans_rank") and fn.endswith(".jsonl")):
            continue
        with open(os.path.join(directory, fn)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail line
                if isinstance(rec, dict) and rec.get("kind") == "span":
                    out.append(rec)
    return out


class SpanTailer:
    """Incremental reader of ONE growing ``spans_rank*.jsonl`` file.

    ``poll()`` returns the span records appended since the last poll
    without re-reading consumed bytes: the cursor only ever advances past
    COMPLETE lines (ending in a newline), so a torn tail — a writer
    SIGKILLed mid-line, or simply a line still being appended — is left
    in place and re-read on the next poll once its newline lands. The
    same skip discipline as the batch ``load_spans`` path applies to
    complete-but-unparseable or foreign lines. A file that shrinks or is
    replaced (a test reset the directory) resets the cursor to zero
    rather than erroring. Stdlib-only, shared by the live-telemetry
    shipper (observability/live.py) and ``scripts/trace_report.py
    --follow``."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.offset:  # truncated/replaced: start over
            self.offset = 0
        if size == self.offset:
            return []
        out: List[dict] = []
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read(size - self.offset)
        except OSError:
            return []
        end = chunk.rfind(b"\n")
        if end < 0:
            return []  # only a torn tail so far; keep the cursor put
        consumed = chunk[:end + 1]
        self.offset += len(consumed)
        for raw in consumed.split(b"\n"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw.decode("utf-8", "replace"))
            except ValueError:
                continue  # unparseable complete line: skip like load_spans
            if isinstance(rec, dict) and rec.get("kind") == "span":
                out.append(rec)
        return out


def compute_burn(total: int, over_target: int, bad: int,
                 admitted: int, objective: dict) -> dict:
    """Error-budget burn rates for one SLO class against one declared
    objective record (``serving/protocol.SLO_OBJECTIVES`` shape). Used
    verbatim by BOTH the post-hoc trace summary and the live aggregator
    (observability/live.py), so the two planes are definitionally
    comparable:

    * latency burn = fraction of completed requests over
      ``latency_target_s``, divided by the latency error budget
      ``1 - latency_slo``;
    * availability burn = fraction of admitted requests that did not
      complete (shed or failed), divided by ``1 - availability_slo``.

    1.0 = burning budget exactly as fast as it accrues; > 1.0 sustained
    = eventual SLO violation."""
    lat_budget = max(1.0 - float(objective.get("latency_slo", 0.95)), 1e-9)
    avail_budget = max(1.0 - float(objective.get("availability_slo", 0.999)),
                       1e-9)
    frac_over = (over_target / total) if total else 0.0
    frac_bad = (bad / admitted) if admitted else 0.0
    return {
        "latency_target_s": float(objective.get("latency_target_s", 0.0)),
        "frac_over_target": round(frac_over, 6),
        "burn_rate_latency": round(frac_over / lat_budget, 6),
        "frac_unavailable": round(frac_bad, 6),
        "burn_rate_availability": round(frac_bad / avail_budget, 6),
    }


def validate_trees(spans: List[dict]) -> List[str]:
    """Structural problems across the merged span set: a trace with no
    (or more than one) root, or a parent_id that resolves to no span in
    its trace. Empty list = every trace is one contiguous tree."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(s.get("trace_id", "?"), []).append(s)
    problems = []
    for tid, ss in sorted(by_trace.items()):
        ids = {s.get("span_id") for s in ss}
        roots = [s for s in ss if not s.get("parent_id")]
        if len(roots) != 1:
            problems.append(
                f"trace {tid}: {len(roots)} roots "
                f"({sorted(str(s.get('name')) for s in roots)})")
        for s in ss:
            p = s.get("parent_id")
            if p and p not in ids:
                problems.append(
                    f"trace {tid}: span {s.get('name')} orphaned "
                    f"(parent {p} not in trace)")
    return problems


def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(int(round(q / 100.0 * (len(vs) - 1))), len(vs) - 1)
    return vs[idx]


def summarize_spans(spans: List[dict], objectives: Optional[dict] = None
                    ) -> dict:
    """Per-SLO-class latency attribution over the serving trees: for each
    ``srv_request`` root, child spans are bucketed into the phases of
    ``PHASE_OF`` and expressed as shares of the root duration
    (``other`` absorbs the untracked remainder, so every request's
    shares sum to exactly 1.0). Pure function over loaded records.
    Roots carrying a ``tenant`` attr additionally feed a per-tenant
    table (``tenants``: request/shed/failed counts, per-class mix,
    latency quantiles, mean phase shares) alongside the per-class one —
    the post-hoc side of the accounting plane's attribution.

    ``objectives`` (the ``serving/protocol.SLO_OBJECTIVES`` table, passed
    by callers that can reach it — this module stays standalone) adds an
    exact post-hoc ``objectives`` block per class via ``compute_burn``,
    the reconciliation target for the live plane's windowed burn rates."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(s.get("trace_id", "?"), []).append(s)

    per_class: Dict[str, dict] = {}
    per_tenant: Dict[str, dict] = {}
    requests = 0
    unfinished = 0
    for ss in by_trace.values():
        root = next((s for s in ss if s.get("name") == "srv_request"
                     and not s.get("parent_id")), None)
        if root is None:
            continue
        requests += 1
        attrs = root.get("attrs") or {}
        slo = str(attrs.get("slo", "unknown"))
        cls = per_class.setdefault(slo, {
            "requests": 0, "resubmitted": 0, "shed": 0, "failed": 0,
            "latency": [], "shares": {p: [] for p in PHASES}})
        # tenant attribution rides the same root attr the router sets;
        # untenanted roots carry no attr and stay out of the table
        buckets = [cls]
        tenant = attrs.get("tenant")
        if tenant:
            tn = per_tenant.setdefault(str(tenant), {
                "requests": 0, "resubmitted": 0, "shed": 0, "failed": 0,
                "latency": [], "shares": {p: [] for p in PHASES},
                "by_class": {}})
            tn["by_class"][slo] = tn["by_class"].get(slo, 0) + 1
            buckets.append(tn)
        status = attrs.get("status")
        if status == "shed":
            for b in buckets:
                b["shed"] += 1
            continue
        if status not in ("done", "failed"):
            unfinished += 1
            continue
        if status == "failed":
            for b in buckets:
                b["failed"] += 1
        dur = float(root.get("dur_s", 0.0))
        if dur <= 0.0:
            continue
        for b in buckets:
            b["requests"] += 1
        if int(attrs.get("resubmits", 0) or 0) > 0:
            for b in buckets:
                b["resubmitted"] += 1
        for b in buckets:
            b["latency"].append(dur)
        sums = {p: 0.0 for p in PHASES}
        for s in ss:
            phase = PHASE_OF.get(s.get("name"))
            if phase is not None:
                sums[phase] += float(s.get("dur_s", 0.0))
        total = sum(sums.values())
        # a resubmitted request counts both attempts' phases; normalize
        # so shares stay a partition of the request's wall time
        scale = (dur / total) if total > dur else 1.0
        acc = 0.0
        for p in PHASES[:-1]:
            share = sums[p] * scale / dur
            for b in buckets:
                b["shares"][p].append(share)
            acc += share
        for b in buckets:
            b["shares"]["other"].append(max(1.0 - acc, 0.0))

    classes = {}
    for slo, cls in sorted(per_class.items()):
        classes[slo] = {
            "requests": cls["requests"],
            "resubmitted": cls["resubmitted"],
            "shed": cls["shed"],
            "latency_seconds": {
                "p50": round(_pct(cls["latency"], 50), 6),
                "p95": round(_pct(cls["latency"], 95), 6),
            },
            "phase_share": {
                p: {"mean": round(sum(v) / len(v), 6) if v else 0.0,
                    "p50": round(_pct(v, 50), 6),
                    "p95": round(_pct(v, 95), 6)}
                for p, v in cls["shares"].items()
            },
        }
        obj = (objectives or {}).get(slo)
        if obj:
            lat = cls["latency"]
            target = float(obj.get("latency_target_s", 0.0))
            over = sum(1 for v in lat if v > target)
            admitted = cls["requests"] + cls["shed"]
            bad = cls["shed"] + cls["failed"]
            classes[slo]["objectives"] = compute_burn(
                len(lat), over, bad, admitted, obj)
    tenants = {}
    for tenant, tn in sorted(per_tenant.items()):
        tenants[tenant] = {
            "requests": tn["requests"],
            "resubmitted": tn["resubmitted"],
            "shed": tn["shed"],
            "failed": tn["failed"],
            "by_class": dict(sorted(tn["by_class"].items())),
            "latency_seconds": {
                "p50": round(_pct(tn["latency"], 50), 6),
                "p95": round(_pct(tn["latency"], 95), 6),
            },
            "phase_share": {
                p: round(sum(v) / len(v), 6) if v else 0.0
                for p, v in tn["shares"].items()
            },
        }
    return {
        "schema": 1,
        "ts": round(time.time(), 6),
        "spans": len(spans),
        "traces": len(by_trace),
        "requests": requests,
        "unfinished": unfinished,
        "classes": classes,
        "tenants": tenants,
    }


def summarize_dir(directory: Optional[str],
                  objectives: Optional[dict] = None) -> Optional[dict]:
    """``summarize_spans`` over a telemetry dir; None when the dir holds
    no span files (so fleet aggregation skips the write entirely)."""
    if not directory:
        return None
    spans = load_spans(directory)
    if not spans:
        return None
    return summarize_spans(spans, objectives=objectives)
