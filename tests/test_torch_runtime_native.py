"""The port's host runtime (``paddle_tpu_torch/runtime/csrc/host_rt.cc``
through ``runtime/native.py`` and ``runtime/__init__.py``) against the
reference's (``csrc/paddle_tpu_rt.cc``), case for case with
``tests/test_runtime_native.py`` but its store cases: the port's store is
``torch.distributed.TCPStore`` (``tests/test_torch_store*.py``).

The two libraries are separate builds with separate state, so each case
runs the same program through both and compares: the arena's stats after
each step of one alloc / free program, ``stack_samples`` bit for bit, and
the tracer's exported names, counts and nesting. The C++ smoke test
(``runtime/csrc/host_rt_test.cc``) links against the built library, so a
symbol hidden by ``-fvisibility=hidden`` fails there, not only in ctypes;
its sanitizer builds are slow-marked, as the reference's are.
"""
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import runtime as ref_runtime
from paddle_tpu_torch import runtime
from paddle_tpu_torch.runtime import native

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "paddle_tpu_torch" / "runtime" / "csrc"


def _exports(path):
    return set(re.findall(r"PT_EXPORT [^(]*?\b(pt_\w+)\(",
                          Path(path).read_text()))


def test_native_library_builds():
    assert runtime.native_available()
    path = Path(native.lib_path())
    assert path.exists() and path.parent.name == "_build"
    assert path.is_relative_to(ROOT / "paddle_tpu_torch" / "runtime")
    assert "paddle_tpu_torch/runtime/_build/" in (
        ROOT / ".gitignore").read_text().splitlines()


def test_c_abi_is_the_reference_s_without_its_store():
    """The port's own copy: the reference's C entry points but the TCP
    store's, built from the port's source, not the repo's ``csrc/``."""
    ref = _exports(ROOT / "csrc" / "paddle_tpu_rt.cc")
    port = _exports(CSRC / "host_rt.cc")
    assert port == {n for n in ref if not n.startswith("pt_store_")}
    assert len(port) == 13
    assert Path(native._SRC) == CSRC / "host_rt.cc"


def _arena_program(arena_cls):
    """One alloc / free program; the stats after each step."""
    a = arena_cls(chunk_bytes=1 << 20)
    out = []
    p1 = a.alloc(1000)
    p2 = a.alloc(2000)
    out.append(a.stats())
    a.free(p1)
    a.free(p2)
    out.append(a.stats())
    p3 = a.alloc(2500)  # the free list satisfies it: no growth
    out.append(a.stats())
    big = a.alloc(3 << 20)  # larger than a chunk: a chunk of its own
    out.append(a.stats())
    a.free(big)
    a.free(p3)
    a.free(p3)  # double free: ignored
    out.append(a.stats())
    return out


def test_arena_alloc_free_stats():
    got = _arena_program(runtime.HostArena)
    assert got[0]["allocated_bytes"] >= 3000
    assert got[0]["reserved_bytes"] >= 1 << 20
    assert got[0]["alloc_count"] == 2
    assert got[1]["allocated_bytes"] == 0
    assert got[1]["peak_allocated_bytes"] >= 3000
    assert got[2]["reserved_bytes"] == got[1]["reserved_bytes"]
    assert got[-1]["allocated_bytes"] == 0
    assert got == _arena_program(ref_runtime.HostArena)


def _coalesce(arena_cls):
    a = arena_cls(chunk_bytes=1 << 16)
    ptrs = [a.alloc(4096) for _ in range(8)]
    for p in ptrs[::2] + ptrs[1::2]:
        a.free(p)
    before = a.stats()
    big = a.alloc(8 * 4096)  # fits the coalesced chunk without growing
    after = a.stats()
    a.free(big)
    return before, after


def test_arena_coalescing_reuse():
    before, after = _coalesce(runtime.HostArena)
    assert after["reserved_bytes"] == before["reserved_bytes"]
    assert (before, after) == _coalesce(ref_runtime.HostArena)


def test_arena_array_roundtrip():
    a = runtime.HostArena()
    arr, ptr = a.alloc_array((4, 8), np.float32)
    arr[:] = np.arange(32, dtype=np.float32).reshape(4, 8)
    assert arr.sum() == np.arange(32).sum()
    assert a.stats()["allocated_bytes"] >= 128
    a.free(ptr)
    assert a.stats()["allocated_bytes"] == 0


def test_stack_samples_matches_numpy():
    rng = np.random.default_rng(0)
    for shape, n, dt in (((16, 16), 32, np.float32),   # inline copies
                         ((256, 256), 64, np.float32),  # the thread pool
                         ((128,), 8, np.int64), ((), 5, np.int32)):
        samples = [rng.standard_normal(shape).astype(dt) for _ in range(n)]
        got = runtime.stack_samples(samples)
        np.testing.assert_array_equal(got, np.stack(samples))
        assert got.dtype == dt
        np.testing.assert_array_equal(got,
                                      ref_runtime.stack_samples(samples))
    out = np.empty((4, 3), np.float64)
    assert runtime.stack_samples([np.ones(3)] * 4, out=out) is out


def test_stack_samples_fallback_mixed_shapes():
    with pytest.raises(ValueError):
        runtime.stack_samples([])
    assert runtime.stack_samples([np.ones((2,))]).shape == (1, 2)
    strided = [np.arange(10.0)[::2] for _ in range(3)]  # not contiguous
    np.testing.assert_array_equal(runtime.stack_samples(strided),
                                  np.stack(strided))
    with pytest.raises(ValueError):  # np.stack's own refusal
        runtime.stack_samples([np.ones(2), np.ones(3)])


def test_collate_stacks_through_the_native_stacker(monkeypatch):
    """``io.default_collate_fn`` assembles array and tensor leaves with
    ``stack_samples``; its batches and dtypes are unchanged."""
    from paddle_tpu_torch import io

    calls = []
    real = runtime.stack_samples
    monkeypatch.setattr(runtime, "stack_samples",
                        lambda s, out=None: calls.append(len(s)) or real(s))
    batch = [(np.full((3,), i, np.float32), torch.tensor([i, i + 1]), i)
             for i in range(4)]
    x, y, z = io.default_collate_fn(batch)
    assert calls == [4, 4]
    np.testing.assert_array_equal(x.numpy(), np.stack([b[0] for b in batch]))
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    assert y.tolist() == [[i, i + 1] for i in range(4)]
    assert z.tolist() == [0, 1, 2, 3]


def _nesting(events):
    """(name, enclosing event's name or None) of each event, sorted."""
    out = []
    for e in events:
        parents = [p for p in events if p is not e
                   and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        parent = min(parents, key=lambda p: p["dur"])["name"] \
            if parents else None
        out.append((e["name"], parent))
    return sorted(out, key=lambda t: (t[0], t[1] or ""))


def _traced(rt):
    rt.trace_start()
    with rt.RecordEvent("step", cat="train"):
        with rt.RecordEvent("forward"):
            pass
        with rt.RecordEvent("backward"):
            with rt.RecordEvent("allreduce"):
                pass
    with rt.RecordEvent("step", cat="train"):
        pass
    rt.trace_stop()
    with rt.RecordEvent("after_stop"):  # not recorded
        pass
    return rt.trace_export()


def test_tracer_records_and_exports():
    events = _traced(runtime)
    assert {e["name"] for e in events} == {"step", "forward", "backward",
                                           "allreduce"}
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0
    ref = _traced(ref_runtime)
    assert sorted(e["name"] for e in events) == sorted(
        e["name"] for e in ref)
    assert _nesting(events) == _nesting(ref)
    assert {(e["name"], e["cat"]) for e in events} == {
        (e["name"], e["cat"]) for e in ref}
    assert not runtime.trace_enabled()


def test_tracer_threads_and_escaping():
    runtime.trace_start()

    def rec(t):
        for i in range(200):
            runtime.trace_record('q"uo\\te', 1000 + i, 10, tid=t)

    threads = [threading.Thread(target=rec, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    runtime.trace_stop()
    events = runtime.trace_export()
    assert len(events) == 800
    assert {e["name"] for e in events} == {'q"uo\\te'}
    assert sorted({e["tid"] for e in events}) == [0, 1, 2, 3]
    assert runtime.now_ns() > 0


def test_host_memory_stats_surface():
    from paddle_tpu_torch import device

    keys = {"allocated_bytes", "reserved_bytes", "peak_allocated_bytes",
            "alloc_count"}
    assert set(runtime.host_memory_stats()) == keys
    assert set(device.host_memory_stats()) == keys
    assert runtime.default_arena() is runtime.default_arena()


def test_disable_native_falls_back():
    """``PADDLE_TPU_DISABLE_NATIVE`` leaves the library unloaded, as in the
    reference: ``stack_samples`` is ``np.stack``, the stats are zeros, the
    tracer records nothing and ``HostArena`` refuses."""
    code = (
        "import numpy as np\n"
        "from paddle_tpu_torch import runtime\n"
        "assert not runtime.native_available()\n"
        "s = [np.arange(6.0).reshape(2, 3)] * 3\n"
        "assert (runtime.stack_samples(s) == np.stack(s)).all()\n"
        "assert set(runtime.host_memory_stats().values()) == {0}\n"
        "runtime.trace_start()\n"
        "with runtime.RecordEvent('x'):\n"
        "    pass\n"
        "assert runtime.trace_export() == [] and not runtime.trace_enabled()\n"
        "try:\n"
        "    runtime.HostArena()\n"
        "except RuntimeError:\n"
        "    print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PADDLE_TPU_DISABLE_NATIVE="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _cpp_test(tmp_path, *flags):
    exe = tmp_path / "host_rt_test"
    lib = native.lib_path()
    build = subprocess.run(
        ["g++", "-std=c++17", "-Wall", "-Wextra", "-pthread", *flags, "-o",
         str(exe), str(CSRC / "host_rt_test.cc"),
         *([lib, f"-Wl,-rpath,{os.path.dirname(lib)}"] if not flags
           else [str(CSRC / "host_rt.cc")])],
        capture_output=True, text=True, timeout=300)
    if build.returncode != 0:
        return build
    return subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=300)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_cpp_host_rt_test_binary(tmp_path):
    assert runtime.native_available()
    r = _cpp_test(tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RT_TEST PASS" in r.stdout


@pytest.mark.slow
@pytest.mark.parametrize("sanitizer", ["address", "thread", "undefined"])
def test_cpp_sanitizers(tmp_path, sanitizer):
    r = _cpp_test(tmp_path, "-O1", "-g", f"-fsanitize={sanitizer}",
                  "-fno-omit-frame-pointer")
    if r.returncode != 0 and ("cannot find" in r.stderr
                              or "not found" in r.stderr):
        pytest.skip(f"toolchain lacks the {sanitizer} sanitizer runtime")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RT_TEST PASS" in r.stdout
