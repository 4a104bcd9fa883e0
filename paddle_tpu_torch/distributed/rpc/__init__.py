"""paddle.distributed.rpc: worker-to-worker RPC (counterpart of
``paddle_tpu/distributed/rpc/__init__.py``).

Reference capability: ``python/paddle/distributed/rpc/`` (init_rpc /
rpc_sync / rpc_async / get_worker_info / shutdown), which Paddle builds on
a C++ brpc agent. Here the agent is a thread-pool TCP server per worker,
and the endpoints rendezvous through ``runtime.TCPStore``. Payloads are
pickled ``(fn, args, kwargs)`` in length-prefixed frames; results (or
remote exceptions, re-raised at the caller) are pickled back on the same
connection. The card never rides this path: tensors in a payload are
pickled through the host.

Only functions importable at the callee (module-level functions, their
partials, picklable callables) can be sent, as in the reference.

Trust model (the reference's brpc agent's): every worker executes
callables sent by any peer that can reach its port. RPC is for the
workers of ONE job on a trusted network; do not expose the agent ports
beyond it.
"""
from __future__ import annotations

import os
import pickle
import socket
import socketserver
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

__all__ = [
    "init_rpc",
    "rpc_sync",
    "rpc_async",
    "shutdown",
    "get_worker_info",
    "get_all_worker_infos",
    "get_current_worker_info",
    "WorkerInfo",
]

_HDR = struct.Struct("!Q")


@dataclass(frozen=True)
class WorkerInfo:
    """Mirrors the reference's WorkerInfo (name, rank, ip, port)."""

    name: str
    rank: int
    ip: str
    port: int


def _send_frame(sock, payload: bytes) -> None:
    # two sendalls instead of one concatenation: never copies the
    # (possibly multi-MB pickled) payload into a fresh buffer
    sock.sendall(_HDR.pack(len(payload)))
    sock.sendall(payload)


def _recv_frame(sock) -> bytes:
    buf = b""
    while len(buf) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(buf))
        if not chunk:
            raise ConnectionError("rpc: peer closed during header")
        buf += chunk
    (n,) = _HDR.unpack(buf)
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(min(1 << 20, n - len(out)))
        if not chunk:
            raise ConnectionError("rpc: peer closed during body")
        out += chunk
    return bytes(out)


class _AgentServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _AgentHandler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            req = _recv_frame(self.request)
        except ConnectionError:
            return
        try:
            fn, args, kwargs = pickle.loads(req)
            result = ("ok", fn(*args, **kwargs))
        except BaseException as e:  # remote exceptions travel to the caller
            result = ("err", e)
        try:
            reply = pickle.dumps(result)
        except BaseException as e:  # unpicklable result/exception (TypeError,
            # PicklingError, recursion, ...): report instead of dropping the
            # connection and surfacing an opaque ConnectionError at the caller
            reply = pickle.dumps(("err", RuntimeError(f"rpc reply failed: {e}")))
        try:
            _send_frame(self.request, reply)
        except OSError:
            pass


class _Agent:
    def __init__(self, name, rank, world_size, store, server, workers):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.store = store
        self.server = server
        self.workers = workers  # name -> WorkerInfo
        self.pool = ThreadPoolExecutor(
            max_workers=int(os.environ.get("PADDLE_RPC_CLIENT_THREADS", "8")),
            thread_name_prefix="rpc-client",
        )


_agent: _Agent | None = None
_lock = threading.Lock()


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Start this worker's RPC agent and rendezvous with the others.

    ``name`` must be unique per worker. ``rank``/``world_size``/
    ``master_endpoint`` default to the launch env
    (``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` / ``PADDLE_MASTER``).
    Rank 0 hosts the TCPStore; every worker publishes its (name, ip, port)
    and blocks until the full worker table is known.
    """
    global _agent
    from ...runtime import TCPStore

    with _lock:
        if _agent is not None:
            raise RuntimeError("init_rpc called twice (call shutdown() first)")
        rank = int(os.environ["PADDLE_TRAINER_ID"] if rank is None else rank)
        world_size = int(
            os.environ["PADDLE_TRAINERS_NUM"] if world_size is None else world_size
        )
        if master_endpoint is None:
            # PADDLE_MASTER itself is the process group's store and + 1 the
            # launcher's rank negotiation (see launch()); the rpc store
            # meets on + 2, as the reference's does
            master = os.environ["PADDLE_MASTER"]
            if master.startswith("tcp://"):
                master = master[len("tcp://"):]
            host, sport = master.rsplit(":", 1)
            master_endpoint = f"{host}:{int(sport) + 2}"
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world_size {world_size}")

        server = _AgentServer(("0.0.0.0", 0), _AgentHandler)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()

        store = None
        try:
            host, sport = master_endpoint.rsplit(":", 1)
            store = TCPStore(
                host=host, port=int(sport), is_master=rank == 0
            )
            ip = _self_ip(host)
            store.set(f"__rpc/worker/{rank}", pickle.dumps((name, rank, ip, port)))

            workers = {}
            for r in range(world_size):
                info = WorkerInfo(
                    *pickle.loads(store.get(f"__rpc/worker/{r}", 120.0))
                )
                if info.name in workers:
                    raise ValueError(f"duplicate rpc worker name {info.name!r}")
                workers[info.name] = info
        except BaseException:
            # failed rendezvous must not leak the bound agent port / server
            # thread / store connection (a retry would stack leaked servers)
            server.shutdown()
            server.server_close()
            if store is not None:
                store.close()
            raise
        _agent = _Agent(name, rank, world_size, store, server, workers)


def _self_ip(master_host: str) -> str:
    if master_host in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((master_host, 1))
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()


def _require_agent() -> _Agent:
    if _agent is None:
        raise RuntimeError("rpc is not initialized; call init_rpc first")
    return _agent


def _call(info: WorkerInfo, payload: bytes, timeout: float):
    with socket.create_connection(
        (info.ip, info.port), timeout=None if timeout <= 0 else timeout
    ) as sock:
        _send_frame(sock, payload)
        reply = _recv_frame(sock)
    try:
        status, value = pickle.loads(reply)
    except BaseException as e:
        # e.g. the remote exception's class isn't importable here — surface
        # a decodable error instead of losing the reply entirely
        raise RuntimeError(
            f"rpc reply from {info.name!r} undecodable: {type(e).__name__}: {e}"
        ) from e
    if status == "err":
        raise value
    return value


def rpc_sync(to, fn, args=None, kwargs=None, timeout=-1):
    """Run ``fn(*args, **kwargs)`` on worker ``to``; returns its result.

    Remote exceptions re-raise here. ``timeout`` <= 0 means wait forever
    (reference default ``timeout=-1``).
    """
    return rpc_async(to, fn, args, kwargs, timeout).result()


def rpc_async(to, fn, args=None, kwargs=None, timeout=-1) -> Future:
    """Like rpc_sync but returns a ``concurrent.futures.Future``.

    The reference returns its own FutureWrapper with ``.wait()``; a stdlib
    Future exposes ``.result()``, and ``.wait`` is aliased for parity.
    """
    agent = _require_agent()
    if to not in agent.workers:
        raise ValueError(f"unknown rpc worker {to!r} (have {sorted(agent.workers)})")
    payload = pickle.dumps((fn, tuple(args or ()), dict(kwargs or {})))
    fut = agent.pool.submit(_call, agent.workers[to], payload, float(timeout))
    fut.wait = fut.result  # reference-API alias
    return fut


def get_worker_info(name) -> WorkerInfo:
    return _require_agent().workers[name]


def get_all_worker_infos():
    return sorted(_require_agent().workers.values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    agent = _require_agent()
    return agent.workers[agent.name]


def shutdown():
    """Graceful barrier + teardown: every worker arrives before any server
    stops, so no in-flight rpc can hit a dead agent (the reference's
    ``shutdown`` has the same all-gather semantics)."""
    global _agent
    with _lock:
        if _agent is None:
            return
        agent, _agent = _agent, None
    # drain OUR outbound calls before the barrier: a queued rpc_async must
    # reach its peer while every server is still guaranteed alive
    agent.pool.shutdown(wait=True)
    store = agent.store
    try:
        # master-closes-last rendezvous: the rank-0 store server must
        # outlive every client's final request
        store.asymmetric_handshake(
            "__rpc/shutdown", agent.rank, agent.world_size, 120.0
        )
    finally:
        # a crashed peer (handshake timeout) must not leak our server
        # thread / bound port / store connection
        agent.server.shutdown()
        agent.server.server_close()
        store.close()
