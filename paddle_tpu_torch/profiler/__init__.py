"""paddle.profiler: tracing and performance summaries (counterpart of
``paddle_tpu/profiler/__init__.py``).

- The device tracer is ``torch.profiler.profile`` with the CPU activity
  and, when ``ProfilerTarget.GPU`` is a target and a card is present, the
  CUDA activity (CUPTI): the card's kernels, copies and the host's
  ``record_function`` spans on one timeline. The paddle scheduler's
  ``READY`` state prepares it (``prepare_trace``: CUPTI collecting, as in
  torch's own warm-up, whose records the window drops), its ``RECORD``
  states start and stop it; each stop synchronizes the card (every kernel
  launched in the window lands in the trace) and writes the window's
  chrome trace to ``{worker_}device_trace.json`` in the export
  directory.
- The host tracer is the native trace buffer (``runtime.trace_*``):
  ``RecordEvent`` spans recorded while a window is open, written at each
  stop as ``{worker_}host_trace.json``, which ``load_profiler_result``
  reads back.
- ``summary()`` reports the step times and a process-wide host aggregator
  of every ``RecordEvent`` (counts and wall time), as the reference does.
- ``timer_only=True`` traces nothing: step times and the aggregator only.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from enum import Enum
from typing import Callable, Iterable, List, Optional

import torch

from .. import runtime as _runtime

__all__ = ["ProfilerTarget", "ProfilerState", "make_scheduler", "SortedKeys",
           "export_chrome_tracing", "RecordEvent", "reset_host_events",
           "Profiler", "profile", "start_profiler", "stop_profiler",
           "ProfilerResult", "load_profiler_result"]


class ProfilerTarget(Enum):
    """The reference's members; ``GPU`` is the card."""
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int = 0, ready: int = 0, record: int = 1,
                   repeat: int = 0, skip_first: int = 0):
    """paddle.profiler.make_scheduler: the step -> state machine."""
    cycle = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle if cycle else 0
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


class SortedKeys(Enum):
    """paddle.profiler.SortedKeys (the host timer's subset)."""
    CPUTotal = 0
    CPUAvg = 1
    Calls = 2
    Name = 3


#: string aliases accepted wherever a SortedKeys is
_SORT_ALIASES = {"total": SortedKeys.CPUTotal, "avg": SortedKeys.CPUAvg,
                 "count": SortedKeys.Calls, "calls": SortedKeys.Calls,
                 "name": SortedKeys.Name}


def _resolve_sort(sorted_by) -> SortedKeys:
    if sorted_by is None:
        return SortedKeys.CPUTotal
    if isinstance(sorted_by, SortedKeys):
        return sorted_by
    key = _SORT_ALIASES.get(str(sorted_by).lower())
    if key is None:
        raise ValueError(
            f"summary(sorted_by={sorted_by!r}): expected a SortedKeys or one "
            f"of {sorted(_SORT_ALIASES)}")
    return key


_TIME_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}


def _default_dir() -> str:
    return os.environ.get("PADDLE_TPU_PROFILE_DIR", os.path.join(
        tempfile.gettempdir(), "paddle_tpu_profile"))


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory: the traces go under ``dir_name``;
    ``worker_name`` prefixes their files (``{worker}_host_trace.json``,
    ``{worker}_device_trace.json``) so workers sharing a directory do not
    clobber each other. The Profiler applies the config at construction:
    the traces are written at each window's stop, before on_trace_ready
    fires."""

    def handler(prof):
        prof._export_dir = dir_name
        if worker_name:
            prof._worker_name = worker_name

    handler._export_config = (dir_name, worker_name)
    return handler


class RecordEvent:
    """Scoped host annotation (the reference's ``platform::RecordEvent``):
    a ``torch.profiler.record_function`` span on the device tracer's
    timeline, a native host-trace event while a window records, and a row
    of ``Profiler.summary()``."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._t0 = None
        self._t0_ns = None

    def begin(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        # a native timestamp only while the host tracer records: two ctypes
        # calls and a mutex per event are real cost in an untraced loop
        self._t0_ns = _runtime.now_ns() if _runtime.trace_enabled() else None
        _host_events[self.name][0] += 1

    def end(self):
        if self._rf is None:
            return
        self._rf.__exit__(None, None, None)
        _host_events[self.name][1] += time.perf_counter() - self._t0
        if self._t0_ns is not None and _runtime.trace_enabled():
            _runtime.trace_record(self.name, self._t0_ns,
                                  _runtime.now_ns() - self._t0_ns,
                                  tid=threading.get_ident() % (1 << 31))
        self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


_host_events = collections.defaultdict(lambda: [0, 0.0])  # name: [n, s]


def reset_host_events() -> None:
    """Clear the process-wide RecordEvent aggregator (back-to-back
    Profiler runs reset it, or the second summary() counts the first
    run's events too)."""
    _host_events.clear()


def _activities(targets) -> list:
    acts = torch.profiler.ProfilerActivity
    targets = (list(targets) if targets is not None
               else [ProfilerTarget.CPU, ProfilerTarget.GPU])
    out = [acts.CPU]
    if ProfilerTarget.GPU in targets and torch.cuda.is_available():
        out.append(acts.CUDA)
    return out


class Profiler:
    def __init__(self, *, targets: Optional[Iterable] = None, scheduler=None,
                 on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False):
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, ready=0,
                                             record=hi - lo, repeat=1)
        else:
            self._scheduler = None
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._activities = _activities(targets)
        self._torch_kw = dict(record_shapes=record_shapes,
                              profile_memory=profile_memory,
                              with_flops=with_flops)
        self._export_dir = _default_dir()
        self._worker_name = None
        # export_chrome_tracing carries its config on the handler: apply it
        # now, since the traces are written at stop, before it runs
        cfg = getattr(on_trace_ready, "_export_config", None)
        if cfg is not None:
            self._export_dir, self._worker_name = cfg
        self._step = 0
        self._tracing = False
        self._device_prof = None
        #: the last window's device chrome trace (None before one closed)
        self.device_trace_path: Optional[str] = None
        self._step_times = []
        self._last_step_t = None
        #: every scheduler state as applied, step 0's first
        self._state_history: List[ProfilerState] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._last_step_t = time.perf_counter()
        if self._timer_only:
            return self
        if self._scheduler is None:
            self._start_trace()
        else:
            # step 0's state applies to the first step, which runs between
            # start() and the first step() call
            self._apply_state(self._scheduler(self._step))
        return self

    def stop(self):
        if self._tracing:
            self._stop_trace()
        elif self._device_prof is not None:  # prepared, never started
            prof, self._device_prof = self._device_prof, None
            prof.start_trace()
            prof.stop_trace()
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        return self

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self._step += 1
        if self._scheduler is not None and not self._timer_only:
            self._apply_state(self._scheduler(self._step))

    def _apply_state(self, state: ProfilerState):
        self._state_history.append(state)
        if state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            if not self._tracing:
                self._start_trace()
        elif self._tracing:
            self._stop_trace()
        if state == ProfilerState.READY:
            self._prepare_trace()

    def _file(self, kind: str) -> str:
        name = (f"{self._worker_name}_{kind}_trace.json" if self._worker_name
                else f"{kind}_trace.json")
        return os.path.join(self._export_dir, name)

    def _prepare_trace(self):
        """The device tracer made and collecting before the window opens,
        so a record lost as CUPTI starts is the warm-up step's, which the
        window drops (without it, ``chip_smoke.py`` phase 57c's window
        lost its first step's first two layers of kernels after phases
        1-57b had run in the process)."""
        if self._device_prof is not None:
            return
        try:
            prof = torch.profiler.profile(activities=self._activities,
                                          **self._torch_kw)
            prof.prepare_trace()
            self._device_prof = prof
        except Exception:
            self._device_prof = None

    def _start_trace(self):
        _runtime.trace_start()
        try:
            self._prepare_trace()
            self._device_prof.start_trace()
            self._tracing = True
        except Exception:
            # keep the host tracer symmetric with the failed device trace,
            # or it stays on (and accumulating) for the rest of the process
            _runtime.trace_stop()
            self._device_prof = None
            self._tracing = False

    def _stop_trace(self):
        prof, self._device_prof = self._device_prof, None
        self._tracing = False
        if prof is not None:
            if torch.profiler.ProfilerActivity.CUDA in self._activities:
                torch.cuda.synchronize()  # the window's kernels complete
            prof.stop()
            os.makedirs(self._export_dir, exist_ok=True)
            self.device_trace_path = self._file("device")
            prof.export_chrome_trace(self.device_trace_path)
        _runtime.trace_stop()
        # the host RecordEvents as a chrome trace beside the device trace
        events = _runtime.trace_export()
        if events:
            os.makedirs(self._export_dir, exist_ok=True)
            with open(self._file("host"), "w") as f:
                json.dump({"traceEvents": events}, f)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting ---------------------------------------------------------

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Host-timer report: step times, then the RecordEvent table.
        ``sorted_by`` orders the table (a SortedKeys, or "total" / "avg" /
        "count" / "name"; default total time, descending); ``time_unit``
        is "s", "ms" or "us"."""
        unit = str(time_unit).lower()
        if unit not in _TIME_UNITS:
            raise ValueError(
                f"summary(time_unit={time_unit!r}): expected one of "
                f"{sorted(_TIME_UNITS)}")
        scale = _TIME_UNITS[unit]
        key = _resolve_sort(sorted_by)
        lines = ["-- paddle_tpu profiler summary " + "-" * 30]
        if self._step_times:
            ts = self._step_times
            lines.append(
                f"steps: {len(ts)}  avg: {sum(ts) / len(ts) * scale:.2f} "
                f"{unit}  min: {min(ts) * scale:.2f} {unit}  max: "
                f"{max(ts) * scale:.2f} {unit}")
        if _host_events:
            items = list(_host_events.items())
            if key is SortedKeys.Name:
                items.sort(key=lambda kv: kv[0])
            elif key is SortedKeys.Calls:
                items.sort(key=lambda kv: (-kv[1][0], kv[0]))
            elif key is SortedKeys.CPUAvg:
                items.sort(key=lambda kv: (-kv[1][1] / max(kv[1][0], 1),
                                           kv[0]))
            else:
                items.sort(key=lambda kv: (-kv[1][1], kv[0]))
            lines.append(f"{'event':40s} {'count':>8s} "
                         f"{'total ' + unit:>12s} {'avg ' + unit:>12s}")
            for name, (cnt, secs) in items:
                lines.append(
                    f"{name:40s} {cnt:8d} {secs * scale:12.2f} "
                    f"{secs * scale / max(cnt, 1):12.2f}")
        if self.device_trace_path is not None:
            lines.append(f"device trace (torch.profiler): "
                         f"{self.device_trace_path}")
        out = "\n".join(lines)
        print(out)
        return out


_global_prof: Optional[Profiler] = None


@contextlib.contextmanager
def profile(dir_name: Optional[str] = None):
    """Trace everything inside into ``dir_name``."""
    prof = Profiler(on_trace_ready=export_chrome_tracing(
        dir_name or _default_dir()))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def start_profiler(dir_name: Optional[str] = None):
    global _global_prof
    if _global_prof is not None:
        _global_prof.stop()
    _global_prof = Profiler(on_trace_ready=export_chrome_tracing(
        dir_name or _default_dir())).start()


def stop_profiler(*a, **k):
    global _global_prof
    if _global_prof is not None:
        _global_prof.stop()
        _global_prof = None


class ProfilerResult:
    """Programmatic view of an exported host chrome trace
    (``host_trace.json`` / ``{worker}_host_trace.json``): enough for
    scripted assertions ("did my_region run 5 times and stay under
    2 ms?")."""

    def __init__(self, path: str, events: List[dict]):
        self.path = path
        #: raw chrome-trace event dicts (name / ph / ts / dur in us)
        self.events = events

    def __len__(self) -> int:
        return len(self.events)

    def names(self) -> List[str]:
        return sorted({e.get("name") for e in self.events if e.get("name")})

    def _named(self, name: str) -> List[dict]:
        return [e for e in self.events if e.get("name") == name]

    def count(self, name: str) -> int:
        return len(self._named(name))

    def total_duration(self, name: str) -> float:
        """Summed duration of complete ("ph": "X") events, microseconds."""
        return float(sum(e.get("dur", 0) for e in self._named(name)
                         if e.get("ph", "X") == "X"))

    def time_range(self) -> Optional[tuple]:
        """(first_ts, last_end_ts) over all events, microseconds."""
        spans = [(e["ts"], e["ts"] + e.get("dur", 0))
                 for e in self.events if "ts" in e]
        if not spans:
            return None
        return min(s for s, _ in spans), max(e for _, e in spans)


def load_profiler_result(file_path: str) -> ProfilerResult:
    """Reload an exported host trace (the file, or the export directory:
    ``host_trace.json`` first, else the lexicographically first
    ``*_host_trace.json``)."""
    path = file_path
    if os.path.isdir(path):
        default = os.path.join(path, "host_trace.json")
        if os.path.isfile(default):
            path = default
        else:
            named = sorted(n for n in os.listdir(path)
                           if n.endswith("_host_trace.json"))
            if not named:
                raise FileNotFoundError(
                    f"load_profiler_result({file_path!r}): no "
                    "host_trace.json or *_host_trace.json in directory")
            path = os.path.join(file_path, named[0])
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    return ProfilerResult(path, list(events))
