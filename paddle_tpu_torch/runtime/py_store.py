"""Pure-Python TCPStore (counterpart of ``paddle_tpu/runtime/py_store.py``,
the same code and wire protocol).

``runtime.TCPStore`` uses it instead of ``torch.distributed.TCPStore``
when ``PADDLE_STORE_FORCE_PY=1`` or chaos store-fault injection asks for
it: the fault hooks live here. The protocol is private to this module (the
torch store and this one don't interoperate — a job uses one or the other
on every process).

Robustness contract:

* every socket op runs under a DEADLINE — a dead or wedged server turns
  into a ``TimeoutError`` naming the op and key, never an indefinite hang
  inside ``socket.recv``;
* connect retries with exponential backoff + jitter up to the caller's
  timeout, so a client starting before the master's listener is up (the
  normal launch race) converges without hammering the host;
* idempotent ops (get/wait/check/set/del) transparently reconnect and
  re-issue once after a dropped connection; ``add`` never auto-retries (a
  replay would double-count a rank).

Env knobs (read lazily so tests can flip them per-case):

  PADDLE_STORE_OP_TIMEOUT   deadline for non-blocking ops (set/add/check/
                            del) and the connect phase default, seconds
                            (default 60)
  PADDLE_STORE_RPC_SLACK    extra client-side slack on top of a blocking
                            get/wait's server-side timeout, seconds
                            (default 15) — the window in which a live
                            server's "timed out" reply must arrive
  PADDLE_STORE_RETRY_BASE   initial reconnect backoff, seconds (default 0.05)
  PADDLE_STORE_RETRY_CAP    max per-attempt backoff, seconds (default 2.0)
"""
from __future__ import annotations

import os
import pickle
import random
import socket
import socketserver
import struct
import threading
import time

from .. import observability as _obs


def _knob(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def op_timeout() -> float:
    return _knob("PADDLE_STORE_OP_TIMEOUT", 60.0)


def rpc_slack() -> float:
    return _knob("PADDLE_STORE_RPC_SLACK", 15.0)


def _chaos():
    """The chaos harness, or None when inert — the import itself is gated
    so the normal path never pays for (or depends on) the testing pkg."""
    if os.environ.get("PADDLE_CHAOS", "0") in ("0", ""):
        return None
    from ..testing import chaos

    return chaos if chaos.store_faults_enabled() else None


def _send_msg(sock, obj, deadline=None, what="store op"):
    data = pickle.dumps(obj)
    payload = struct.pack("<Q", len(data)) + data
    if deadline is not None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"PyTCPStore: deadline expired sending {what}")
        sock.settimeout(remaining)
    try:
        sock.sendall(payload)
    except socket.timeout as e:
        raise TimeoutError(f"PyTCPStore: timed out sending {what}") from e


def _recv_msg(sock, deadline=None, what="store op"):
    """Receive one length-prefixed message, honoring `deadline`
    (monotonic). A dead server becomes TimeoutError naming the op instead
    of an unbounded blocking recv."""

    def _read(n):
        buf = b""
        while len(buf) < n:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"PyTCPStore: timed out waiting for reply to {what}")
                sock.settimeout(remaining)
            try:
                c = sock.recv(min(1 << 16, n - len(buf)))
            except socket.timeout as e:
                raise TimeoutError(
                    f"PyTCPStore: timed out waiting for reply to {what}") from e
            if not c:
                raise ConnectionError("store connection closed")
            buf += c
        return buf

    (n,) = struct.unpack("<Q", _read(8))
    return pickle.loads(_read(n))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr):
        self.kv = {}
        self.cv = threading.Condition()
        super().__init__(addr, _Handler)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: _Server = self.server
        while True:
            try:
                cmd, key, arg = _recv_msg(self.request)
            except (ConnectionError, EOFError, OSError, TimeoutError):
                return
            # Responses are sent OUTSIDE srv.cv: a client with a full TCP
            # buffer would otherwise block sendall while holding the global
            # lock, stalling every other rank's store op.
            if cmd == "set":
                with srv.cv:
                    srv.kv[key] = arg
                    srv.cv.notify_all()
                resp = True
            elif cmd == "get":
                deadline = time.monotonic() + arg if arg > 0 else None
                with srv.cv:
                    while key not in srv.kv:
                        remaining = None if deadline is None else deadline - time.monotonic()
                        if remaining is not None and remaining <= 0:
                            break
                        srv.cv.wait(remaining)
                    resp = srv.kv.get(key)
            elif cmd == "add":
                with srv.cv:
                    cur = int.from_bytes(srv.kv.get(key, b"\0" * 8), "little", signed=True)
                    nv = cur + arg
                    srv.kv[key] = nv.to_bytes(8, "little", signed=True)
                    srv.cv.notify_all()
                resp = nv
            elif cmd == "check":
                with srv.cv:
                    resp = key in srv.kv
            elif cmd == "del":
                with srv.cv:
                    resp = srv.kv.pop(key, None) is not None
            else:
                return
            try:
                _send_msg(self.request, resp)
            except (ConnectionError, OSError, TimeoutError):
                return


def _connect_with_backoff(host, port, timeout, why="store"):
    """Dial with exponential backoff + jitter until `timeout` elapses.

    The first attempts race the master's listener coming up — that's the
    normal launch sequence, not an error — so retry quietly, but when the
    deadline passes, say exactly who we couldn't reach and for how long."""
    deadline = time.monotonic() + timeout
    delay = _knob("PADDLE_STORE_RETRY_BASE", 0.05)
    cap = _knob("PADDLE_STORE_RETRY_CAP", 2.0)
    attempt = 0
    last_err = None
    while True:
        attempt += 1
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            _obs.event("store_connect_failed", host=host, port=port, why=why,
                       attempts=attempt - 1, timeout=timeout,
                       last_error=repr(last_err))
            raise ConnectionError(
                f"PyTCPStore: cannot reach {why} at {host}:{port} after "
                f"{attempt - 1} attempts over {timeout:.1f}s "
                f"(last error: {last_err!r}) — is the master rank up, and "
                "do PADDLE_MASTER/port match on every rank?")
        try:
            sock = socket.create_connection((host, port),
                                            timeout=min(remaining, max(delay, 1.0)))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError as e:
            last_err = e
            _obs.inc("store_connect_attempts_total")
            # full jitter: sleep U(0, delay), then grow the ceiling
            time.sleep(min(random.uniform(0, delay), max(0.0, remaining)))
            delay = min(delay * 2, cap)


class PyTCPStore:
    #: ops safe to re-issue after a dropped connection (`add` is excluded:
    #: replaying an increment would double-count a rank)
    _IDEMPOTENT = frozenset({"get", "check", "del", "set"})

    def __init__(self, host="127.0.0.1", port=0, is_master=False, timeout=60.0):
        self._server = None
        self._host = host
        self.timeout = float(timeout)
        if is_master:
            # Bind the master address specifically (not 0.0.0.0): master
            # election depends on non-owners failing this bind.
            self._server = _Server((host, port))
            self.port = self._server.server_address[1]
            threading.Thread(target=self._server.serve_forever, daemon=True).start()
        else:
            self.port = port
        self._sock = _connect_with_backoff(host, self.port, self.timeout)
        self._lock = threading.Lock()

    def _reconnect(self):
        try:
            self._sock.close()
        except OSError:
            pass
        _obs.inc("store_reconnect_total")
        self._sock = _connect_with_backoff(self._host, self.port, self.timeout)

    def _rpc(self, cmd, key, arg=None, op_deadline=None):
        """One request/response, under a deadline. Idempotent ops survive a
        dropped connection by reconnecting (with backoff) and re-issuing
        ONCE — covers both injected drops and a master that restarted its
        listener between ops."""
        what = f"{cmd}({key!r})"
        if op_deadline is None:
            op_deadline = time.monotonic() + op_timeout()
        chaos = _chaos()
        t0 = time.perf_counter()
        with self._lock:
            if chaos is not None:
                chaos.store_latency()
                # drops only on ops the retry path may re-issue; severing
                # an `add` would poison the counter semantics by design
                if cmd in self._IDEMPOTENT and chaos.store_should_drop():
                    try:
                        self._sock.close()
                    except OSError:
                        pass
            for retry in (False, True):
                try:
                    _send_msg(self._sock, (cmd, key, arg), op_deadline, what)
                    resp = _recv_msg(self._sock, op_deadline, what)
                    _obs.observe("store_op_seconds",
                                 time.perf_counter() - t0, op=cmd)
                    return resp
                except (ConnectionError, OSError) as e:
                    if isinstance(e, TimeoutError):
                        raise
                    if retry or cmd not in self._IDEMPOTENT:
                        raise ConnectionError(
                            f"PyTCPStore: {what} failed ({e!r}) and is not "
                            "retryable") from e
                    _obs.inc("store_op_retry_total", op=cmd)
                    self._reconnect()

    def set(self, key, value):
        data = value.encode() if isinstance(value, str) else bytes(value)
        self._rpc("set", key, data)

    def get(self, key, timeout=60.0):
        # the server blocks up to `timeout` for the key; the client allows
        # that plus slack for the reply itself — so a DEAD server is
        # distinguished from a key that simply never arrived
        deadline = time.monotonic() + float(timeout) + rpc_slack()
        v = self._rpc("get", key, float(timeout), op_deadline=deadline)
        if v is None:
            raise TimeoutError(f"PyTCPStore.get({key!r}) timed out after "
                               f"{timeout}s (key never set)")
        return v

    def add(self, key, delta=1):
        return self._rpc("add", key, int(delta))

    def wait(self, key, timeout=60.0):
        self.get(key, timeout)

    def check(self, key):
        return self._rpc("check", key)

    def delete_key(self, key):
        return self._rpc("del", key)

    # barrier lives on the TCPStore facade (runtime/__init__.py), composed
    # from add/set/wait which already delegate here.

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
        if self._server is not None:
            self._server.shutdown()
            self._server = None
