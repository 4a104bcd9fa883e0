#!/usr/bin/env python3
"""Phase 57c of ``chip_smoke.py`` with the K3 kernels' places on its
device trace.

    python3 scripts/k3_trace_probe.py N       # 57c N times in one process
    python3 scripts/k3_trace_probe.py --full  # the whole chip_smoke.py

With N, builds the kernels and phase 49's GPT-3 1.3B worker model once,
then runs ``chip_smoke.phase_profiled_engine`` (``paddle.profiler`` over 8
engine steps; K3's kernels on the device trace against the wrapper's
counters) N times. With ``--full``, ``chip_smoke.main()`` first, where
57c comes after phases 1-57b, then in the same process 57c three more
times: as it is (``again``), with the profiler waiting 100 ms after the
window's closing synchronize before it stops the device tracer
(``stop_delay``), and with it waiting 100 ms, after a synchronize, once
the tracer started (``start_delay``). For each trial it prints ``TRIAL i ok`` or
``TRIAL i FAIL <the gate's message>``, then a ``DIAG`` JSON line, times in
microseconds from the first ``engine_step`` span's start: the spans, the
``paged_split_kernel`` records that start inside each span (or within
5 ms after its end), the groups of them (a new group after a gap of more
than 1 ms), the first and last kernel's start and the last kernel's end,
and the kernels recorded before the first span and after the last.
Needs one CUDA card of compute capability 9.0 and ``nvcc``.
"""
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

DIAG = []


def _diagnosed(counted):
    """``chip_smoke.trace_k3`` that also appends the trace's K3 places to
    DIAG."""
    def trace_k3(events):
        on, kernels = counted(events)
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("name") == "engine_step"
                       and e.get("cat") == "user_annotation")
        t0 = spans[0][0]
        split = sorted(e["ts"] for e in kernels
                       if "paged_split" in e.get("name", ""))
        groups, last = [], None
        for ts in split:
            if last is None or ts - last > 1000:
                groups.append([round(ts - t0), 0])
            groups[-1][1] += 1
            last = ts
        starts = sorted(e["ts"] for e in kernels)
        DIAG.append(dict(
            spans=[(round(a - t0), round(b - t0)) for a, b in spans],
            split_per_span=[sum(1 for t in split if a <= t <= b + 5000)
                            for a, b in spans],
            split_groups=groups, first_kernel=round(starts[0] - t0),
            last_kernel=round(starts[-1] - t0),
            last_kernel_end=round(max(e["ts"] + e.get("dur", 0)
                                      for e in kernels) - t0),
            kernels_before_first_span=sum(1 for t in starts if t < t0),
            kernels_after_last_span=sum(1 for t in starts
                                        if t > spans[-1][1])))
        return on, kernels
    return trace_k3


def _trial(name, run):
    try:
        run()
        print("TRIAL", name, "ok", flush=True)
    except AssertionError as e:
        print("TRIAL", name, "FAIL", e, flush=True)
    print("DIAG", json.dumps(DIAG[-1] if DIAG else None), flush=True)


def _delayed(fn, before):
    """``fn`` with a synchronize and a 100 ms wait before (or after) it."""
    def wrapped(self):
        if not before:
            fn(self)
        torch.cuda.synchronize()
        time.sleep(0.1)
        if before:
            fn(self)
    return wrapped


def main(arg):
    cs.trace_k3 = _diagnosed(cs.trace_k3)
    if arg == "--full":
        _trial("full", cs.main)
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.serving import worker as worker_mod

    build.library()
    model = worker_mod.build_worker_model(worker_mod.build_arg_parser(
    ).parse_args(cs.serving_argv(cs.SERVING_MODEL)))
    smi = cs.smi_line()

    def run():
        cs.phase_profiled_engine(pa, smi, model, tempfile.mkdtemp())

    if arg != "--full":
        for i in range(int(arg)):
            _trial(i, run)
        return
    stop, start = P.Profiler._stop_trace, P.Profiler._start_trace
    _trial("again", run)
    P.Profiler._stop_trace = _delayed(stop, before=True)
    _trial("stop_delay", run)
    P.Profiler._stop_trace = stop
    P.Profiler._start_trace = _delayed(start, before=False)
    _trial("start_delay", run)
    P.Profiler._start_trace = start


if __name__ == "__main__":
    main(sys.argv[1])
