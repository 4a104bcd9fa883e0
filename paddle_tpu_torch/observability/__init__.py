"""paddle_tpu_torch.observability — structured telemetry (counterpart of
``paddle_tpu/observability/__init__.py``).

Layers, as in the reference:

1. a **metrics registry** (``metrics.MetricsRegistry``: counters, gauges,
   histograms with bounded reservoirs; labels; thread-safe; zero-dep);
2. **exporters**: a Prometheus-style textfile (``metrics_rank{R}.prom``)
   and an append-only JSONL event log (``events_rank{R}.jsonl``), both
   under ``PADDLE_TPU_TELEMETRY_DIR``;
3. **distributed tracing** (``tracing.py``): span trees with
   cross-process context propagation over per-rank
   ``spans_rank{R}.jsonl`` sinks — ``span`` / ``start_span`` /
   ``end_span`` / ``record_span`` re-exported here;
4. **tenant accounting** (``accounting.py``): the per-tenant ledger the
   serving engine and router meter into while telemetry is on;
5. **fleet aggregation** (``fleet.py``): ranks publish registry snapshots
   through a store, rank 0 merges them into ``fleet_metrics.json`` with
   per-rank min / max / mean and straggler flags;
6. **the live plane** (``live.py``): shippers tail the span sinks into
   seq-numbered ``tele`` payloads, an aggregator keeps sliding SLO windows
   and writes ``fleet_health.json`` (``PADDLE_TPU_LIVE_TELEMETRY=1``).

Everything is env-gated on ``PADDLE_TPU_TELEMETRY_DIR``: with it unset,
the module-level helpers below return before touching the registry or the
filesystem, so instrumented hot paths pay one dict lookup in
``os.environ`` and nothing else.

Event records are one JSON object per line, flushed (and the file closed)
per write, so a SIGKILL never loses an already-emitted event and never
leaves a torn line behind a buffered writer.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Optional

from . import catalog
from . import tracing
from .metrics import (  # noqa: F401  (re-exported registry API)
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NAME_RE,
)
from .tracing import (  # noqa: F401  (re-exported span API)
    end_span,
    new_trace_id,
    record_span,
    span,
    start_span,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "telemetry_dir", "enabled", "rank", "registry",
    "counter", "gauge", "histogram",
    "inc", "set_gauge", "observe", "event", "timed", "record_compile",
    "span", "start_span", "end_span", "record_span", "new_trace_id",
    "flush", "snapshot", "reset",
    "fleet_sync", "merge_snapshots",
    "start_live_monitor", "stop_live_monitor",
]

_registry = MetricsRegistry(catalog=catalog.METRICS)
_io_lock = threading.Lock()

# every recorded span also bumps the registry counter; tracing.py itself
# stays stdlib-standalone (trace_report.py loads it without this package)
tracing._counter_hook = (
    lambda name: _registry.counter("trace_spans_total").inc(1, name=name))


# ---------------------------------------------------------------------------
# gating / identity
# ---------------------------------------------------------------------------
def telemetry_dir() -> Optional[str]:
    """The telemetry output directory, or None when telemetry is off.

    Read from the environment on every call (not cached): tests and
    long-lived supervisors flip it per-case/per-child.
    """
    d = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    return d if d else None


def enabled() -> bool:
    return telemetry_dir() is not None


def rank() -> int:
    """This process's rank for file naming / event tagging (launcher env)."""
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or "0")
    except ValueError:
        return 0


def registry() -> MetricsRegistry:
    return _registry


# ---------------------------------------------------------------------------
# registry facade (usable directly; NOT env-gated — callers holding a metric
# object opted in to recording regardless of export state)
# ---------------------------------------------------------------------------
def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", **kwargs) -> Histogram:
    return _registry.histogram(name, help, **kwargs)


# ---------------------------------------------------------------------------
# env-gated recording helpers (the hot-path API)
# ---------------------------------------------------------------------------
def inc(name: str, value: float = 1, **labels) -> None:
    if telemetry_dir() is None:
        return
    _registry.counter(name).inc(value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    if telemetry_dir() is None:
        return
    _registry.gauge(name).set(value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if telemetry_dir() is None:
        return
    _registry.histogram(name).observe(value, **labels)


def event(kind: str, **fields) -> None:
    """Append one record to this rank's JSONL event log (no-op when off)."""
    d = telemetry_dir()
    if d is None:
        return
    rec = {"ts": round(time.time(), 6), "kind": kind, "rank": rank(),
           "pid": os.getpid()}
    rec.update(fields)
    line = json.dumps(rec, default=str) + "\n"
    path = os.path.join(d, f"events_rank{rank()}.jsonl")
    with _io_lock:
        os.makedirs(d, exist_ok=True)
        # open/append/close per event: one O_APPEND write per line is atomic
        # enough for concurrent writers (launcher + worker share rank 0's
        # file) and nothing is buffered when a SIGKILL lands
        with open(path, "a") as f:
            f.write(line)


class timed:
    """Scoped duration -> histogram (and optional event); free when off.

        with observability.timed("checkpoint_save_seconds"):
            ...
    """

    def __init__(self, name: str, event_kind: Optional[str] = None, **labels):
        self._name = name
        self._event_kind = event_kind
        self._labels = labels
        self.seconds: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter() if enabled() else None
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self.seconds = time.perf_counter() - self._t0
            observe(self._name, self.seconds, **self._labels)
            if self._event_kind:
                event(self._event_kind, seconds=round(self.seconds, 6),
                      **self._labels)
        return False


def record_compile(where: str, seconds: float,
                   signature: Optional[str] = None,
                   cache_hit: Optional[bool] = None) -> None:
    """One jit cache miss: count + wall time + an auditable event.

    ``cache_hit`` distinguishes a fresh XLA compile (False) from a
    persistent AOT compile-cache load (True) when the site consulted
    ``runtime.compile_cache``; None means the cache was not in play.
    """
    if telemetry_dir() is None:
        return
    extra = {} if cache_hit is None else {"compile_cache_hit": bool(cache_hit)}
    inc("xla_compile_total", where=where)
    observe("xla_compile_seconds", seconds, where=where)
    event("xla_compile", where=where, seconds=round(seconds, 6),
          signature=(signature or "")[:240], **extra)
    # every compile-instrumented site also traces: one single-span tree
    record_span("compile", dur_s=seconds, where=where,
                signature=(signature or "")[:240], **extra)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
def flush() -> Optional[str]:
    """Write this rank's Prometheus textfile; returns its path (None if off).

    Atomic (tmp + rename) so a scraper or a concurrent reader never sees a
    half-written exposition.
    """
    d = telemetry_dir()
    if d is None:
        return None
    text = _registry.to_prometheus()
    if not text:
        # nothing recorded — don't write (a supervisor that merely IMPORTED
        # this package shares the worker's rank-0 filename; an empty atexit
        # flush from it must not clobber the worker's live exposition)
        return None
    path = os.path.join(d, f"metrics_rank{rank()}.prom")
    # pid alone is NOT unique here: the watchdog beat thread and the main
    # thread (fleet_sync, atexit) flush concurrently in one process, and two
    # writers sharing a tmp name race write→rename (the loser's os.replace
    # throws FileNotFoundError after the winner renamed the tmp away)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with _io_lock:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


def snapshot() -> dict:
    """This rank's full registry state (the fleet-publish payload)."""
    return {"rank": rank(), "ts": round(time.time(), 6),
            "metrics": _registry.snapshot()}


def reset() -> None:
    """Drop all recorded metrics (tests flipping env knobs per-case)."""
    _registry.reset()


# best-effort final export; a no-op when telemetry was never enabled
atexit.register(flush)

# fleet aggregation (store snapshot merge) and the rank-0 live monitor;
# imported last: fleet.py reads this package's helpers at call time
from .fleet import (  # noqa: E402,F401
    fleet_sync,
    merge_snapshots,
    start_live_monitor,
    stop_live_monitor,
)
