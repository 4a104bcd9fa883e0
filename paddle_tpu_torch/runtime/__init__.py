"""paddle_tpu_torch.runtime — the host runtime and the coordination store
(counterpart of ``paddle_tpu/runtime/__init__.py``).

The host side the framework owns, in C++ (``csrc/host_rt.cc``, built at
first use by ``native.py``; ``native_available()`` says whether it
loaded):

- ``HostArena``: an auto-growth best-fit caching allocator for host
  staging buffers, with ``stats()``; ``default_arena`` /
  ``host_memory_stats`` (also ``device.host_memory_stats``).
- ``stack_samples``: ``np.stack`` of equally-shaped samples through the
  native thread pool (``io.default_collate_fn`` assembles batches with
  it); ``np.stack`` itself when the library is missing or the samples
  are not contiguous same-shape arrays.
- the host tracer behind ``paddle.profiler``: ``trace_start`` /
  ``trace_stop`` / ``trace_enabled`` / ``trace_record`` /
  ``trace_export`` (chrome-trace events), ``now_ns`` and the scoped
  ``RecordEvent`` primitive.

``TCPStore`` keeps the reference's API and semantics — ``set`` takes str
or bytes, ``get(key, timeout)`` returns bytes and raises ``TimeoutError``
when the key never arrives, ``add`` returns the new value, ``wait``,
``check``, ``delete_key``, ``barrier``, ``asymmetric_handshake``,
``close`` and ``port`` — on ``torch.distributed.TCPStore``, the port's
store, where the reference has its own in C++ (ROADMAP.md §C, Standing).
The torch store blocks a ``get`` for the STORE's timeout; here every
blocking call carries its own deadline (a ``wait`` with that timeout
first), and torch's ``DistStoreError`` / ``DistNetworkError`` become the
reference's ``TimeoutError`` / ``ConnectionError``.

``PADDLE_STORE_FORCE_PY=1``, or chaos store-fault injection
(``testing.chaos.store_faults_enabled``), selects the pure-Python store of
``py_store.py`` instead, as the reference does: its fault hooks live
there.
"""
from __future__ import annotations

import ctypes
import datetime
import os
import threading
from typing import Optional

import numpy as np

from . import native, py_store

__all__ = ["TCPStore", "store_torch_enabled", "native_available",
           "HostArena", "default_arena", "host_memory_stats",
           "stack_samples", "trace_start", "trace_stop", "trace_enabled",
           "trace_record", "trace_export", "now_ns", "RecordEvent"]


def native_available() -> bool:
    return native.available()


# -- host arena allocator ----------------------------------------------------

class HostArena:
    """Auto-growth best-fit caching allocator for host staging buffers
    (the reference's ``AutoGrowthBestFitAllocator`` capability, on the
    host side: batch buffers before their copy to the card)."""

    def __init__(self, chunk_bytes: int = 64 << 20):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.pt_arena_create(chunk_bytes)

    def alloc_array(self, shape, dtype):
        """Arena-backed storage as ``(ndarray, ptr)``. The array views
        arena memory: keep it only while the arena lives, and release it
        with ``free(ptr)``."""
        dtype = np.dtype(dtype)
        count = int(np.prod(shape))
        nbytes = count * dtype.itemsize
        ptr = self.alloc(nbytes)
        buf = (ctypes.c_char * max(nbytes, 1)).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
        arr.flags.writeable = True
        return arr, ptr

    def alloc(self, nbytes: int) -> int:
        ptr = self._lib.pt_arena_alloc(self._h, max(int(nbytes), 1))
        if not ptr:
            raise MemoryError(f"arena alloc of {nbytes} bytes failed")
        return ptr

    def free(self, ptr: int):
        self._lib.pt_arena_free(self._h, ptr)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.pt_arena_stats(self._h, ctypes.byref(out))
        return {"allocated_bytes": int(out[0]),
                "reserved_bytes": int(out[1]),
                "peak_allocated_bytes": int(out[2]),
                "alloc_count": int(out[3])}

    def __del__(self):
        try:
            self._lib.pt_arena_destroy(self._h)
        except Exception:
            pass


_default_arena: Optional[HostArena] = None
_arena_lock = threading.Lock()


def default_arena() -> Optional[HostArena]:
    """The process's arena, made at first call (None without the
    library)."""
    global _default_arena
    if not native.available():
        return None
    with _arena_lock:
        if _default_arena is None:
            _default_arena = HostArena()
    return _default_arena


def host_memory_stats() -> dict:
    """``paddle.device.cuda.memory_stats``'s analogue for host staging
    memory: the default arena's stats (zeros without the library)."""
    a = default_arena()
    if a is None:
        return {"allocated_bytes": 0, "reserved_bytes": 0,
                "peak_allocated_bytes": 0, "alloc_count": 0}
    return a.stats()


# -- parallel batch assembly -------------------------------------------------

def stack_samples(samples, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``np.stack`` over equally-shaped sample arrays through the native
    thread pool; ``np.stack`` itself when the library is missing or the
    samples are not contiguous arrays of one shape and dtype."""
    lib = native.get_lib()
    n = len(samples)
    if n == 0:
        raise ValueError("empty batch")
    first = samples[0]
    if lib is None or not all(
            isinstance(s, np.ndarray) and s.shape == first.shape
            and s.dtype == first.dtype and s.flags.c_contiguous
            for s in samples):
        return np.stack([np.asarray(s) for s in samples])
    if out is None:
        out = np.empty((n,) + first.shape, dtype=first.dtype)
    ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in samples])
    lib.pt_stack(out.ctypes.data_as(ctypes.c_void_p), ptrs, n,
                 first.nbytes, 0)
    return out


def store_torch_enabled() -> bool:
    """Whether ``TCPStore`` uses ``torch.distributed.TCPStore`` (the
    reference's ``native.store_native_enabled``): False when
    ``PADDLE_STORE_FORCE_PY=1`` or chaos store faults are armed, since the
    fault hooks live in the Python store."""
    if os.environ.get("PADDLE_STORE_FORCE_PY", "0") not in ("0", ""):
        return False
    if os.environ.get("PADDLE_CHAOS", "0") not in ("0", ""):
        from ..testing import chaos

        if chaos.store_faults_enabled():
            return False
    return True


def _td(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=max(float(seconds), 0.0))


class TCPStore:
    """Coordination KV store: the master process runs the server, every
    process (master included) talks to it through a client connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: Optional[float] = None):
        if timeout is None:
            timeout = float(os.environ.get("PADDLE_STORE_TIMEOUT", "60"))
        self.timeout = float(timeout)
        self._py_fallback = None
        self._store = None
        if not store_torch_enabled():
            self._py_fallback = py_store.PyTCPStore(host, port, is_master,
                                                    timeout)
            self.port = self._py_fallback.port
            return
        import torch.distributed as dist

        try:
            self._store = dist.TCPStore(
                host, int(port), is_master=is_master, timeout=_td(timeout),
                wait_for_workers=False)
        except RuntimeError as e:  # torch's DistError and its kinds
            raise ConnectionError(
                f"TCPStore: could not bind/connect {host}:{port}: {e}") from e
        self.port = int(self._store.port) if is_master else int(port)

    def _call(self, what: str, fn, *args):
        """One torch store op with the reference's exceptions."""
        import torch.distributed as dist

        if self._store is None:
            raise ConnectionError(f"TCPStore.{what}: store is closed")
        try:
            return fn(*args)
        except dist.DistStoreError as e:
            if "timeout" in str(e).lower():
                raise TimeoutError(f"TCPStore.{what} timed out: {e}") from e
            raise ConnectionError(f"TCPStore.{what} failed: {e}") from e
        except RuntimeError as e:
            raise ConnectionError(f"TCPStore.{what} failed: {e}") from e

    def set(self, key: str, value) -> None:
        if self._py_fallback:
            return self._py_fallback.set(key, value)
        data = value.encode() if isinstance(value, str) else bytes(value)
        self._call(f"set({key!r})", self._store.set, key, data)

    def get(self, key: str, timeout: float = 60.0) -> bytes:
        if self._py_fallback:
            return self._py_fallback.get(key, timeout)
        self.wait(key, timeout)
        return bytes(self._call(f"get({key!r})", self._store.get, key))

    def add(self, key: str, delta: int = 1) -> int:
        if self._py_fallback:
            return self._py_fallback.add(key, delta)
        return int(self._call(f"add({key!r})", self._store.add, key,
                              int(delta)))

    def wait(self, key: str, timeout: float = 60.0) -> None:
        if self._py_fallback:
            return self._py_fallback.wait(key, timeout)
        self._call(f"wait({key!r})", self._store.wait, [key], _td(timeout))

    def check(self, key: str) -> bool:
        if self._py_fallback:
            return self._py_fallback.check(key)
        return bool(self._call(f"check({key!r})", self._store.check, [key]))

    def delete_key(self, key: str) -> bool:
        if self._py_fallback:
            return self._py_fallback.delete_key(key)
        return bool(self._call(f"delete_key({key!r})",
                               self._store.delete_key, key))

    def asymmetric_handshake(self, ns: str, rank: int, world_size: int,
                             timeout: float = 60.0) -> None:
        """Rendezvous where the master (rank 0) provably finishes last:
        clients end with an acknowledged ``set``, the master ends waiting
        for every client's ack, so the master, whose exit tears down the
        store server, cannot close while a client still has a request in
        flight (reference ``TCPStore.asymmetric_handshake``)."""
        if rank == 0:
            for r in range(1, world_size):
                try:
                    self.wait(f"{ns}/arrived/{r}", timeout)
                except TimeoutError as e:
                    raise TimeoutError(
                        f"rendezvous '{ns}': rank {r} of {world_size} never "
                        f"arrived within {timeout}s — check that rank's "
                        "process is alive and PADDLE_MASTER matches") from e
            self.set(f"{ns}/go", b"1")
            for r in range(1, world_size):
                try:
                    self.wait(f"{ns}/ack/{r}", timeout)
                except TimeoutError as e:
                    raise TimeoutError(
                        f"rendezvous '{ns}': rank {r} arrived but never "
                        f"acknowledged within {timeout}s (it likely died "
                        "between handshake phases)") from e
        else:
            self.set(f"{ns}/arrived/{rank}", b"1")
            try:
                self.wait(f"{ns}/go", timeout)
            except TimeoutError as e:
                raise TimeoutError(
                    f"rendezvous '{ns}': rank {rank} waited {timeout}s for "
                    "the master's go signal — the master (rank 0) is down "
                    "or still waiting on another rank") from e
            self.set(f"{ns}/ack/{rank}", b"1")

    def barrier(self, name: str, world_size: int,
                timeout: float = 60.0) -> None:
        """All ``world_size`` participants rendezvous on ``name``; two
        phases (arrive + ack) so no participant — the master in particular
        — leaves before every participant has passed it."""
        n = self.add(f"__barrier/{name}/count", 1)
        if n == world_size:
            self.set(f"__barrier/{name}/done", b"1")
        self.wait(f"__barrier/{name}/done", timeout)
        m = self.add(f"__barrier/{name}/acks", 1)
        if m == world_size:
            self.set(f"__barrier/{name}/fin", b"1")
        self.wait(f"__barrier/{name}/fin", timeout)

    def close(self):
        if self._py_fallback:
            return self._py_fallback.close()
        self._store = None  # the last reference: torch closes the socket

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# -- host tracer -------------------------------------------------------------

def trace_start():
    lib = native.get_lib()
    if lib is not None:
        lib.pt_trace_start()


def trace_stop():
    lib = native.get_lib()
    if lib is not None:
        lib.pt_trace_stop()


def trace_enabled() -> bool:
    lib = native.get_lib()
    return lib is not None and bool(lib.pt_trace_enabled())


def trace_record(name: str, ts_ns: int, dur_ns: int, cat: str = "op",
                 tid: int = 0):
    lib = native.get_lib()
    if lib is not None:
        lib.pt_trace_record(name.encode(), cat.encode(), ts_ns, dur_ns, tid)


def trace_export() -> list:
    """Drain the native trace buffer as a list of chrome-trace event
    dicts (``ph`` "X", ``ts`` / ``dur`` in microseconds)."""
    import json

    lib = native.get_lib()
    if lib is None:
        return []
    # events may land between the sizing call and the export: loop until
    # the buffer was large enough for what was written
    cap = int(lib.pt_trace_export(None, 0))
    while True:
        buf = ctypes.create_string_buffer(max(cap, 2))
        n = int(lib.pt_trace_export(buf, max(cap, 2)))
        if n <= max(cap, 2):
            return json.loads(buf.raw[:n].decode())
        cap = n


def now_ns() -> int:
    lib = native.get_lib()
    if lib is not None:
        return lib.pt_now_ns()
    import time

    return time.perf_counter_ns()


class RecordEvent:
    """Scoped host trace event into the native buffer: the primitive under
    ``paddle_tpu_torch.profiler.RecordEvent`` (which also marks the torch
    profiler's timeline and feeds ``summary()``)."""

    def __init__(self, name: str, cat: str = "op"):
        self.name = name
        self.cat = cat

    def __enter__(self):
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        lib = native.get_lib()
        if lib is not None and lib.pt_trace_enabled():
            trace_record(self.name, self._t0, now_ns() - self._t0, self.cat,
                         threading.get_ident() % (1 << 31))
        return False
