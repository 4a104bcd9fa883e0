"""Fleet-wide metric aggregation over the coordination store
(counterpart of ``paddle_tpu/observability/fleet.py``: plain Python, kept
as the port's own copy).

Every rank publishes its registry snapshot as JSON under a well-known store
key; rank 0 collects all of them, computes per-metric min/max/mean across
ranks, flags stragglers, and writes one ``fleet_metrics.json`` under the
telemetry dir — the first place cross-rank skew ("which rank is lagging?")
becomes visible without attaching a debugger to every host.

The store is the port's ``runtime.TCPStore``; the telemetry instance
lives on the rendezvous master's port + 3 (port + 2 is the heartbeat
watchdog's), hosted by rank 0. ``PADDLE_MASTER`` may be ``host:port`` or
a ``tcp://host:port`` URL; a ``file://`` rendezvous has no port to offset,
so such a job skips the store merge (each rank's files stay). A store
handed in explicitly (e.g. an application's own) is used as-is and never
closed here.

``fleet_sync`` is tolerant by design: a rank that died before publishing
shows up in ``missing_ranks`` instead of failing the merge, and peers that
cannot reach rank 0 (it may already have exited) log and return rather
than raise — telemetry must never take down a job that was otherwise
finishing cleanly.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, Optional

#: default straggler factor: mean step-time above fleet mean by this
#: fraction flags a straggler (override via PADDLE_TPU_STRAGGLER_FACTOR)
STRAGGLER_THRESHOLD = 1.2

#: histograms compared rank-to-rank for straggler diagnosis
_STRAGGLER_METRICS = ("train_step_seconds",)


def straggler_threshold() -> float:
    """The straggler-diagnosis factor, from ``PADDLE_TPU_STRAGGLER_FACTOR``
    when set (re-read per merge — supervisors flip it per run). Values
    that do not parse or are <= 1.0 (which would flag every rank, or
    none meaningfully) are diagnosed to stderr and fall back to the
    default."""
    raw = os.environ.get("PADDLE_TPU_STRAGGLER_FACTOR")
    if not raw:
        return STRAGGLER_THRESHOLD
    try:
        v = float(raw)
    except ValueError:
        v = -1.0
    if v <= 1.0:
        print(f"[telemetry] invalid PADDLE_TPU_STRAGGLER_FACTOR={raw!r} "
              f"(need a float > 1.0); using {STRAGGLER_THRESHOLD}",
              file=sys.stderr)
        return STRAGGLER_THRESHOLD
    return v

_store = None  # cached telemetry store (rank 0 hosts; binding twice fails)
_synced = False


def _env_int(name: str, default: int) -> int:
    """``name``, else torch's spelling of it (``RANK`` / ``WORLD_SIZE``,
    which ``init_parallel_env`` also reads), else ``default``."""
    alt = {"PADDLE_TRAINER_ID": "RANK",
           "PADDLE_TRAINERS_NUM": "WORLD_SIZE"}.get(name)
    for key in (name, alt):
        if key and os.environ.get(key):
            try:
                return int(os.environ[key])
            except ValueError:
                return default
    return default


# ---------------------------------------------------------------------------
# merge (pure; unit-testable without processes)
# ---------------------------------------------------------------------------
def _scalar_views(metric_name: str, data: dict):
    """(label_str, scalar) pairs used for cross-rank aggregation: counter/
    gauge values directly, histogram means."""
    if data["type"] in ("counter", "gauge"):
        return list(data.get("values", {}).items())
    return [(ls, s["mean"]) for ls, s in data.get("series", {}).items()]


def _sample_counts(data: dict):
    """(label_str, count) pairs for histogram series — the weights the
    straggler merge needs so a nearly-idle rank cannot dilute the fleet
    mean (see merge_snapshots)."""
    if data.get("type") in ("counter", "gauge"):
        return []
    return [(ls, int(s.get("count", 0) or 0))
            for ls, s in data.get("series", {}).items()]


def merge_snapshots(snaps: Dict[int, dict], world_size: int) -> dict:
    """Merge per-rank snapshots (as returned by ``observability.snapshot``)
    into the fleet_metrics document. Pure function — no store, no files."""
    aggregate: dict = {}
    counts: dict = {}  # name -> label_str -> rank -> histogram samples
    for r, snap in sorted(snaps.items()):
        for name, data in snap.get("metrics", {}).items():
            for label_str, value in _scalar_views(name, data):
                slot = aggregate.setdefault(name, {}).setdefault(
                    label_str, {"per_rank": {}})
                slot["per_rank"][str(r)] = value
            for label_str, n in _sample_counts(data):
                counts.setdefault(name, {}).setdefault(
                    label_str, {})[str(r)] = n
    for name, by_label in aggregate.items():
        for label_str, slot in by_label.items():
            vals = slot["per_rank"]
            nums = {r: v for r, v in vals.items()
                    if isinstance(v, (int, float))}
            if not nums:
                continue
            lo_r = min(nums, key=nums.get)
            hi_r = max(nums, key=nums.get)
            slot.update(
                min=nums[lo_r], max=nums[hi_r],
                mean=sum(nums.values()) / len(nums),
                min_rank=int(lo_r), max_rank=int(hi_r))

    stragglers = []
    factor = straggler_threshold()
    for name in _STRAGGLER_METRICS:
        for label_str, slot in aggregate.get(name, {}).items():
            nums = {r: v for r, v in slot["per_rank"].items()
                    if isinstance(v, (int, float))}
            if len(nums) < 2:
                continue
            # Weight each rank's mean by its SAMPLE COUNT: the unweighted
            # mean-of-means let a nearly-idle rank (3 fast steps) drag the
            # fleet mean down and flag healthy ranks — or dilute a real
            # straggler below the threshold. The weighted mean is the
            # true mean over all recorded steps.
            weights = counts.get(name, {}).get(label_str, {})
            wtotal = sum(weights.get(r, 0) for r in nums)
            if wtotal > 0:
                mean = sum(v * weights.get(r, 0)
                           for r, v in nums.items()) / wtotal
            else:
                mean = sum(nums.values()) / len(nums)
            if mean <= 0:
                continue
            slot["weighted_mean"] = mean
            for r, v in nums.items():
                if v > mean * factor:
                    stragglers.append({
                        "rank": int(r), "metric": name, "labels": label_str,
                        "mean_seconds": v, "fleet_mean_seconds": mean,
                        "samples": weights.get(r, 0),
                        "slowdown": v / mean})
    stragglers.sort(key=lambda s: -s["slowdown"])

    return {
        "schema": 1,
        "ts": round(time.time(), 6),
        "world_size": int(world_size),
        "missing_ranks": sorted(set(range(world_size)) -
                                {int(r) for r in snaps}),
        "stragglers": stragglers,
        "aggregate": aggregate,
        "ranks": {str(r): snap for r, snap in sorted(snaps.items())},
    }


def _write_fleet_metrics(doc: dict) -> str:
    from . import telemetry_dir

    d = telemetry_dir()
    path = os.path.join(d, "fleet_metrics.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(d, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def _slo_objectives() -> Optional[dict]:
    """The declared SLO objectives from serving/protocol.py, or None if
    the serving package is unimportable in this context. Passed into the
    post-hoc trace summary so its per-class burn rates use the same
    table the live plane burns against."""
    try:
        from ..serving.protocol import SLO_OBJECTIVES
        return SLO_OBJECTIVES
    except Exception:
        return None


def _write_trace_summary() -> Optional[str]:
    """Merge this host's span files into ``fleet_trace_summary.json``
    (rank 0, alongside fleet_metrics.json). Skipped when no rank wrote
    spans; never raises — the metrics merge must not die on a torn span
    file."""
    from . import telemetry_dir
    from . import tracing

    d = telemetry_dir()
    if d is None:
        return None
    try:
        doc = tracing.summarize_dir(d, objectives=_slo_objectives())
        if doc is None:
            return None
        path = os.path.join(d, "fleet_trace_summary.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path
    except OSError as e:
        print(f"[telemetry] trace summary write failed: {e!r}",
              file=sys.stderr)
        return None


# ---------------------------------------------------------------------------
# store plumbing
# ---------------------------------------------------------------------------
def _default_store(rank: int, timeout: float):
    """The dedicated telemetry store (master port + 3), cached per process."""
    global _store
    if _store is not None:
        return _store
    master = os.environ.get("PADDLE_MASTER")
    if not master:
        return None
    if "://" in master:
        scheme, _, master = master.partition("://")
        if scheme != "tcp":
            return None
    host, port = master.rsplit(":", 1)
    from ..runtime import TCPStore

    _store = TCPStore(host, int(port) + 3, is_master=(rank == 0),
                      timeout=timeout)
    return _store


def fleet_sync(store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None, timeout: float = 60.0,
               label: str = "default") -> Optional[str]:
    """Publish this rank's snapshot; rank 0 merges and writes
    ``fleet_metrics.json``. Returns the written path on rank 0 (and in
    single-process runs), else None. No-op when telemetry is off.

    Call near the end of training on EVERY rank (or rely on the atexit hook
    ``init_parallel_env`` installs). Rank 0 waits up to ``timeout`` for each
    peer's snapshot; absent peers land in ``missing_ranks``. Peers wait for
    rank 0's done-marker so the file is committed before any rank returns.
    """
    global _synced
    from . import enabled, event, flush, snapshot

    if not enabled():
        return None
    if rank is None:
        rank = _env_int("PADDLE_TRAINER_ID", 0)
    if world_size is None:
        world_size = _env_int("PADDLE_TRAINERS_NUM", 1)
    flush()  # the per-rank prom textfile rides along with every sync
    local = snapshot()
    if world_size < 2:
        path = _write_fleet_metrics(merge_snapshots({rank: local}, 1))
        _write_trace_summary()
        _synced = True
        return path

    if store is None:
        try:
            store = _default_store(rank, timeout)
        except (ConnectionError, OSError, TimeoutError) as e:
            print(f"[telemetry] rank {rank}: fleet store unreachable ({e!r});"
                  " skipping fleet aggregation", file=sys.stderr)
            return None
        if store is None:
            return None
    try:
        store.set(f"__telemetry/{label}/snap/{rank}",
                  json.dumps(local).encode())
        path = None
        if rank == 0:
            snaps = {0: local} if rank == 0 else {}
            for r in range(world_size):
                if r == rank:
                    continue
                try:
                    raw = store.get(f"__telemetry/{label}/snap/{r}", timeout)
                    snaps[r] = json.loads(raw)
                except (TimeoutError, ConnectionError, OSError,
                        ValueError) as e:
                    print(f"[telemetry] rank {r} never published a snapshot "
                          f"({e!r}); aggregating without it",
                          file=sys.stderr)
            doc = merge_snapshots(snaps, world_size)
            path = _write_fleet_metrics(doc)
            # span files land in the shared telemetry dir per rank; the
            # same rank-0 merge point folds them into the attribution table
            _write_trace_summary()
            event("fleet_aggregate", ranks=sorted(snaps),
                  missing=doc["missing_ranks"],
                  stragglers=len(doc["stragglers"]), path=path)
            store.set(f"__telemetry/{label}/done", b"1")
        else:
            try:
                store.wait(f"__telemetry/{label}/done", timeout)
            except (TimeoutError, ConnectionError, OSError):
                pass  # rank 0 died or is slow; our snapshot is published
        _synced = True
        return path
    except (ConnectionError, OSError, TimeoutError) as e:
        print(f"[telemetry] rank {rank}: fleet sync failed ({e!r})",
              file=sys.stderr)
        return None


def fleet_sync_atexit() -> None:
    """Best-effort exit-time sync (installed by init_parallel_env when
    telemetry is on); skipped when an explicit fleet_sync already ran."""
    if _synced:
        return
    timeout = float(os.environ.get("PADDLE_TPU_TELEMETRY_SYNC_TIMEOUT",
                                   "20") or 20)
    try:
        fleet_sync(timeout=timeout)
    except Exception as e:  # exit path: diagnose, never mask the exit code
        print(f"[telemetry] exit-time fleet sync failed: {e!r}",
              file=sys.stderr)


# ---------------------------------------------------------------------------
# rank-0 live monitor (observability/live.py consumer for training fleets)
# ---------------------------------------------------------------------------
_live_monitor = None
_live_stop = None


def start_live_monitor(interval_s: float = 1.0, **agg_kwargs):
    """Start the rank-0 live-telemetry loop: a daemon thread ticking a
    ``LiveAggregator`` that tails every ``spans_rank*.jsonl`` in the
    shared telemetry dir (single-host fleets write into one dir, so rank
    0 sees the whole fleet without any extra wire) and periodically
    writes ``fleet_health.json`` + burn/straggler/imbalance events.
    Serving routers embed their own aggregator instead (serving/router
    feeds it tele frames from remote workers).

    Returns the aggregator, or None when the live plane is off or this
    is not rank 0. Idempotent — a second call returns the running
    monitor."""
    global _live_monitor, _live_stop
    from .live import LiveAggregator, live_enabled

    if not live_enabled() or _env_int("PADDLE_TRAINER_ID", 0) != 0:
        return None
    if _live_monitor is not None:
        return _live_monitor
    agg = LiveAggregator(tail_local=True, **agg_kwargs)
    stop = _live_stop = threading.Event()

    def _loop():
        while not stop.wait(interval_s):
            agg.tick()
        agg.tick()  # final flush so a clean stop commits the last window

    t = threading.Thread(
        target=_loop, name="paddle-tpu-live-monitor", daemon=True)
    t.start()
    _live_monitor = agg
    return agg


def stop_live_monitor() -> None:
    """Stop the rank-0 live loop (leaves the last fleet_health.json in
    place). Safe to call when no monitor is running."""
    global _live_monitor, _live_stop
    if _live_stop is not None:
        _live_stop.set()
    _live_monitor = None
    _live_stop = None
