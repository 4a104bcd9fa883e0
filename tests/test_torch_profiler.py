"""The port's ``paddle.profiler`` (``paddle_tpu_torch/profiler``) against
the reference's, case for case with the profiler cases of
``tests/test_observability.py`` and ``tests/test_aux_subsystems.py``.

The scheduler's state sequences must equal the reference's over a grid of
``closed`` / ``ready`` / ``record`` / ``repeat`` / ``skip_first``, and a
Profiler driven through the same steps must apply the same states. The
summary's rows and call counts must equal the reference's for the same
RecordEvent program; its times are never compared (the reference's own
timing test flickers). A real window on the CPU shows the port's device
tracer (``torch.profiler``) and host tracer (the native buffer) holding
the window's RecordEvent spans, and nothing outside it.
"""
import itertools
import json
import time

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as RP
from paddle_tpu_torch import profiler as P


def _stubbed(prof):
    prof._start_trace = lambda: setattr(prof, "_tracing", True)
    prof._stop_trace = lambda: setattr(prof, "_tracing", False)
    return prof


def _states(pkg, sched, steps):
    prof = _stubbed(pkg.Profiler(scheduler=sched))
    prof.start()
    tracing = [prof._tracing]
    for _ in range(steps):
        prof.step()
        tracing.append(prof._tracing)
    prof.stop()
    return [s.name for s in prof._state_history], tracing


def test_profiler_applies_step0_scheduler_state():
    """Step 0's state applies at start(): with skip_first=1 the first step
    runs CLOSED."""
    got = _states(P, P.make_scheduler(record=1, skip_first=1), 3)
    assert got[0] == ["CLOSED"] + ["RECORD_AND_RETURN"] * 3
    assert got == _states(RP, RP.make_scheduler(record=1, skip_first=1), 3)


def test_profiler_state_sequence_matches_scheduler():
    got = _states(P, P.make_scheduler(closed=1, ready=1, record=2,
                                      repeat=1), 5)
    assert got[0] == ["CLOSED", "READY", "RECORD", "RECORD_AND_RETURN",
                      "CLOSED", "CLOSED"]
    assert got[1][0] is False  # step 0 is CLOSED, not recording
    assert got == _states(RP, RP.make_scheduler(closed=1, ready=1, record=2,
                                                repeat=1), 5)


GRID = list(itertools.product((0, 1, 2), (0, 1), (1, 3), (0, 2), (0, 1)))


@pytest.mark.parametrize("closed,ready,record,repeat,skip_first", GRID)
def test_scheduler_grid_equals_reference(closed, ready, record, repeat,
                                         skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    got = [P.make_scheduler(**kw)(s).name for s in range(24)]
    assert got == [RP.make_scheduler(**kw)(s).name for s in range(24)]
    assert _states(P, P.make_scheduler(**kw), 12) == _states(
        RP, RP.make_scheduler(**kw), 12)


def test_tuple_scheduler_and_enums_equal_reference():
    assert _states(P, (2, 5), 8) == _states(RP, (2, 5), 8)
    for a, b in ((P.ProfilerTarget, RP.ProfilerTarget),
                 (P.ProfilerState, RP.ProfilerState),
                 (P.SortedKeys, RP.SortedKeys)):
        assert [(m.name, m.value) for m in a] == [(m.name, m.value)
                                                  for m in b]


def _rows(text):
    """(event, count) rows of a summary's table, in order."""
    lines = text.splitlines()
    head = next(i for i, l in enumerate(lines) if l.startswith("event"))
    rows = []
    for line in lines[head + 1:]:
        if line.startswith("device trace"):
            break
        rows.append((line[:40].strip(), int(line[40:49])))
    return rows


def _program(pkg):
    """The same RecordEvent program through ``pkg``; its summaries."""
    pkg.reset_host_events()
    for _ in range(3):
        with pkg.RecordEvent("aa_fast"):
            pass
    with pkg.RecordEvent("bb_slow"):
        time.sleep(0.02)
    for _ in range(2):
        with pkg.RecordEvent("cc_mid"):
            time.sleep(0.002)
    prof = pkg.Profiler(timer_only=True)
    prof.start()
    prof.step()
    prof.step()
    prof.stop()
    out = {k: prof.summary(sorted_by=k) for k in ("calls", "name")}
    pkg.reset_host_events()
    return out, prof.summary()


def test_summary_rows_and_counts_equal_reference(capsys):
    got, after_reset = _program(P)
    want, ref_after = _program(RP)
    capsys.readouterr()
    for k in got:
        assert _rows(got[k]) == _rows(want[k]), k
    assert _rows(got["name"]) == [("aa_fast", 3), ("bb_slow", 1),
                                  ("cc_mid", 2)]
    assert "steps: 2" in got["name"]
    assert "aa_fast" not in after_reset and "aa_fast" not in ref_after


def test_summary_sorted_by_and_time_unit(capsys):
    P.reset_host_events()
    try:
        for _ in range(3):
            with P.RecordEvent("aa_fast"):
                pass
        with P.RecordEvent("bb_slow"):
            time.sleep(0.02)
        prof = P.Profiler(timer_only=True)
        prof.start()
        prof.step()
        prof.stop()
        by_total = prof.summary(sorted_by="total")
        assert by_total.index("bb_slow") < by_total.index("aa_fast")
        by_calls = prof.summary(sorted_by=P.SortedKeys.Calls)
        assert by_calls.index("aa_fast") < by_calls.index("bb_slow")
        by_name = prof.summary(sorted_by="name")
        assert by_name.index("aa_fast") < by_name.index("bb_slow")
        by_avg = prof.summary(sorted_by="avg")
        assert by_avg.index("bb_slow") < by_avg.index("aa_fast")
        assert "total us" in prof.summary(time_unit="us")
        assert "total s" in prof.summary(time_unit="s")
        with pytest.raises(ValueError):
            prof.summary(sorted_by="bogus")
        with pytest.raises(ValueError):
            prof.summary(time_unit="minutes")
        P.reset_host_events()
        assert "aa_fast" not in prof.summary()
    finally:
        P.reset_host_events()
        capsys.readouterr()


def test_load_profiler_result(tmp_path):
    doc = {"traceEvents": [
        {"name": "op_a", "ph": "X", "ts": 10, "dur": 5},
        {"name": "op_a", "ph": "X", "ts": 20, "dur": 7},
        {"name": "op_b", "ph": "X", "ts": 30, "dur": 2},
    ]}
    (tmp_path / "host_trace.json").write_text(json.dumps(doc))
    for target in (str(tmp_path), str(tmp_path / "host_trace.json")):
        res = P.load_profiler_result(target)
        ref = RP.load_profiler_result(target)
        assert len(res) == len(ref) == 3
        assert res.names() == ref.names() == ["op_a", "op_b"]
        assert res.count("op_a") == 2
        assert res.total_duration("op_a") == 12.0
        assert res.time_range() == ref.time_range() == (10, 32)
    named = tmp_path / "named"
    named.mkdir()
    (named / "w3_host_trace.json").write_text(json.dumps(doc))
    assert P.load_profiler_result(str(named)).count("op_b") == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        P.load_profiler_result(str(empty))


def test_export_chrome_tracing_worker_name(tmp_path, monkeypatch):
    handler = P.export_chrome_tracing(str(tmp_path), worker_name="w7")
    prof = P.Profiler(on_trace_ready=handler)
    # live from construction: the traces are written at stop, before
    # on_trace_ready fires
    assert prof._export_dir == str(tmp_path) and prof._worker_name == "w7"
    monkeypatch.setattr(P._runtime, "trace_stop", lambda: None)
    monkeypatch.setattr(P._runtime, "trace_export",
                        lambda: [{"name": "x", "ph": "X", "ts": 0, "dur": 1}])
    prof._stop_trace()
    res = P.load_profiler_result(str(tmp_path))
    assert res.path.endswith("w7_host_trace.json") and res.count("x") == 1


def test_profiler_timer_and_events(capsys):
    P.reset_host_events()
    p = P.Profiler(timer_only=True)
    p.start()
    with P.RecordEvent("my_region"):
        _ = torch.ones(4, 4).sum().item()
    p.step()
    p.step()
    p.stop()
    out = p.summary()
    assert "steps: 2" in out and "my_region" in out
    assert p.device_trace_path is None  # timer_only traces nothing
    P.reset_host_events()
    capsys.readouterr()


def test_profiler_scheduler_states():
    sch = P.make_scheduler(closed=1, ready=1, record=2, repeat=1)
    states = [sch(i) for i in range(4)]
    assert states[0] == P.ProfilerState.CLOSED
    assert states[1] == P.ProfilerState.READY
    assert states[3] == P.ProfilerState.RECORD_AND_RETURN


def _window(tmp_path, n, worker=None):
    """A real profiled loop on the CPU: closed 1, ready 1, record ``n``;
    a RecordEvent around each step's matmul."""
    P.reset_host_events()
    prof = P.Profiler(
        targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU],
        scheduler=P.make_scheduler(closed=1, ready=1, record=n),
        on_trace_ready=P.export_chrome_tracing(str(tmp_path), worker))
    x = torch.randn(32, 32)
    prof.start()
    for _ in range(n + 3):
        with P.RecordEvent("engine_step"):
            x = torch.tanh(x @ x)
        prof.step()
    prof.stop()
    return prof


def test_real_window_records_device_and_host_spans(tmp_path, capsys):
    """Only the RECORD window is traced: its N spans are in the device
    trace (torch.profiler's user annotations, beside the matmuls) and in
    the host trace, which ``load_profiler_result`` reads; the summary
    counts every call."""
    n = 3
    prof = _window(tmp_path, n)
    res = P.load_profiler_result(str(tmp_path))
    assert res.count("engine_step") == n
    doc = json.loads(open(prof.device_trace_path).read())
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("name") == "engine_step"
             and e.get("cat") == "user_annotation"]
    assert len(spans) == n
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "")
               for e in events)
    assert _rows(prof.summary()) == [("engine_step", n + 3)]
    assert not prof._tracing and not P._runtime.trace_enabled()
    P.reset_host_events()
    capsys.readouterr()


def test_ready_prepares_the_device_tracer(tmp_path):
    """READY makes the device tracer and starts it collecting (torch's
    warm-up) before the window; RECORD starts that same tracer; a READY
    never followed by RECORD is discarded at stop()."""
    prof = P.Profiler(scheduler=P.make_scheduler(closed=1, ready=1, record=1),
                      on_trace_ready=P.export_chrome_tracing(str(tmp_path)))
    prof.start()                              # step 0: CLOSED
    assert prof._device_prof is None
    prof.step()                               # step 1: READY
    warm = prof._device_prof
    assert warm is not None and not prof._tracing
    prof.step()                               # step 2: RECORD
    assert prof._device_prof is warm and prof._tracing
    prof.step()
    prof.stop()
    assert prof._device_prof is None and not prof._tracing
    cold = P.Profiler(scheduler=P.make_scheduler(closed=0, ready=1, record=1))
    cold.start()                              # step 0: READY
    assert cold._device_prof is not None
    cold.stop()
    assert cold._device_prof is None and cold.device_trace_path is None
    P.reset_host_events()


def test_repeat_windows_and_worker_names(tmp_path):
    prof = _window(tmp_path, 2, worker="w1")
    assert prof.device_trace_path.endswith("w1_device_trace.json")
    res = P.load_profiler_result(str(tmp_path))
    assert res.path.endswith("w1_host_trace.json")
    # the last window's trace: 5 steps after start() cover one window of
    # 2 (steps 2, 3); the second cycle reaches READY only
    assert res.count("engine_step") == 2
    P.reset_host_events()


def test_profile_context_and_start_stop(tmp_path):
    with P.profile(str(tmp_path / "a")) as prof:
        with P.RecordEvent("ctx"):
            torch.ones(3).sum()
    assert P.load_profiler_result(str(tmp_path / "a")).count("ctx") == 1
    assert prof.device_trace_path.startswith(str(tmp_path / "a"))
    P.start_profiler(str(tmp_path / "b"))
    with P.RecordEvent("global"):
        pass
    P.stop_profiler()
    assert P.load_profiler_result(str(tmp_path / "b")).count("global") == 1
    P.reset_host_events()


def test_gpu_target_without_a_card_traces_the_cpu():
    acts = P._activities([P.ProfilerTarget.GPU])
    want = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        want.append(torch.profiler.ProfilerActivity.CUDA)
    assert acts == want
    assert P._activities([P.ProfilerTarget.CPU]) == want[:1]
    assert np.array_equal(P._activities(None), want)
