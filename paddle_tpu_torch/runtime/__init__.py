"""paddle_tpu_torch.runtime — the coordination store (counterpart of the
``TCPStore`` of ``paddle_tpu/runtime/__init__.py``).

``TCPStore`` keeps the reference's API and semantics — ``set`` takes str
or bytes, ``get(key, timeout)`` returns bytes and raises ``TimeoutError``
when the key never arrives, ``add`` returns the new value, ``wait``,
``check``, ``delete_key``, ``barrier``, ``asymmetric_handshake``,
``close`` and ``port`` — on ``torch.distributed.TCPStore``, the port's
store. The torch store blocks a ``get`` for the STORE's timeout; here every
blocking call carries its own deadline (a ``wait`` with that timeout
first), and torch's ``DistStoreError`` / ``DistNetworkError`` become the
reference's ``TimeoutError`` / ``ConnectionError``.

``PADDLE_STORE_FORCE_PY=1``, or chaos store-fault injection
(``testing.chaos.store_faults_enabled``), selects the pure-Python store of
``py_store.py`` instead, as the reference does: its fault hooks live
there.

Left for later: the reference's host runtime in C++
(``csrc/paddle_tpu_rt.cc``: ``HostArena``, ``stack_samples``, the host
tracer, the native store and its ``wait``), ROADMAP.md §A.8.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

from . import py_store

__all__ = ["TCPStore", "store_torch_enabled"]


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
