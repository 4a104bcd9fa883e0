"""MPMD pipeline execution: each stage runs its own blocks on its own
devices, with reliable boundary queues between stages (counterpart of
``paddle_tpu/distributed/mpmd.py``, arXiv:2412.14374).

The reference compiles one program per stage (``fwd``, a recompute-in-
backward ``bwd``, and a fused ``loss_grad`` on the last stage) and keeps
them in its compile cache. The port compiles no program: a stage holds the
``SpmdPipeline``'s blocks themselves (``nn.Module`` s, on the stage's
first device) and runs them eagerly, so the kernels the blocks call (K1 /
K2a / K2b through GPT's attention) run on the stage's card. What carries
over:

* **per-stage callables** ``fwd`` (non-last stages, no grad), ``bwd``
  (recomputes the stage's forward from the stashed input, then backward:
  the input's cotangent out, the parameters' gradients accumulated into
  ``.grad`` in schedule order) and ``loss_grad`` (the last stage: the
  blocks, the head and the loss, backward of ``loss / M``). Each stage
  builds them per ``(kind, shapes, width)``; ``compile_count`` counts the
  builds and ``resize`` drops only that stage's, so a stage-local resize
  is testable as in the reference;
* **a device subset and a width per stage**, unequal widths allowed: a
  stage of width ``dp`` splits each micro-batch's rows over its devices
  when ``dp`` divides them (``put_batch``), runs the chunks, and sums the
  parameter gradients on its first device (a device other than the first
  runs a copy of the stage's weights made at the start of each step). A
  ``devices=`` list may repeat a device, so one card shows unequal widths;
* **boundary queues** (activations downstream on ``act<i>``, cotangents
  upstream on ``cot<i>``) on ``serving.transport``'s ``tq`` frames:
  per-channel seqs (``SeqChannels``), cumulative ``tq_ack`` watermarks,
  replay of the unacked tail after a reconnect, every blocking socket
  operation under ``deadline_guard``. Boundary tensors are the only thing
  that crosses the host: a stage's output goes out at the wire dtype
  (``PADDLE_TPU_MPMD_WIRE``: ``raw`` | ``f32`` | ``bf16`` | ``int8``) and
  the receiver puts it on its own devices;
* **the phased schedule table** (``pipeline_parallel.phased_stage_table``,
  gpipe and 1F1B): each stage runner (a thread) replays its stage's
  ``(tick, F/B, micro-batch)`` ops, with ``chaos.mpmd_fence`` before each;
* **per-stage checkpoint shards** (``fleet.elastic.save_stage_shard``):
  the failure unit is one stage; ``restore_shards`` restores every stage
  at ``latest_common_step``.

``cache_dir`` (the reference's per-stage compile cache,
``runtime/compile_cache.py``) is not ported and raises (ROADMAP.md §A.8).
Each step's ``last_step_stats`` go to the ``mpmd_*`` gauges and, under
``PADDLE_TPU_LIVE_TELEMETRY=1``, to the live plane's stage stream
(``export_stage_stats``). On a CUDA stage the blocks launch their kernels
or raise: no stage moves to the CPU unless its devices are the CPU.

This module is the single writer of the ``mpmd_*`` metric and span
families.
"""
from __future__ import annotations

import collections
import os
import queue as _queue
import random
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import observability as _obs
from ..framework.dtype import from_host
from ..serving import transport as _transport
from ..serving.protocol import deadline_guard
from ..testing import chaos

__all__ = [
    "MpmdPipeline", "MpmdStage", "BoundaryEndpoint",
    "local_boundary", "tcp_boundary",
    "ENV_WIRE", "ENV_STAGES", "resolve_wire", "parse_stage_widths",
]

#: wire dtype of boundary tensors (transport.TENSOR_WIRES); ``raw`` / ``f32``
#: are bit-preserving for f32 activations, the trajectory gate's wire
ENV_WIRE = "PADDLE_TPU_MPMD_WIRE"

#: the launch CLI exports the per-stage widths ("dp0,dp1,...") here, so a
#: relaunched worker rebuilds the stage layout it died with
ENV_STAGES = "PADDLE_TPU_MPMD_STAGES"

#: bound on every blocking queue wait (seconds); the deadline guard on the
#: socket operations below it is the watchdog of last resort
_QUEUE_TIMEOUT = float(os.environ.get("PADDLE_TPU_MPMD_TIMEOUT", "120"))

_CACHE_UNPORTED = (
    "MpmdPipeline(cache_dir=...): the per-stage compile cache "
    "(runtime/compile_cache.py) is not ported; the port's stages run "
    "eagerly and compile no program, see ROADMAP.md §A.8")


def resolve_wire(wire: Optional[str] = None) -> str:
    w = wire or os.environ.get(ENV_WIRE, "raw")
    if w not in _transport.TENSOR_WIRES:
        raise ValueError(
            f"{ENV_WIRE}={w!r} not in {_transport.TENSOR_WIRES}")
    return w


def parse_stage_widths(spec: Optional[str] = None) -> Optional[List[int]]:
    """Decode the launch CLI's ENV_STAGES export ("2,2" -> [2, 2])."""
    s = spec if spec is not None else os.environ.get(ENV_STAGES, "")
    if not s:
        return None
    return [int(tok) for tok in s.replace(" ", "").split(",") if tok]


# ---------------------------------------------------------------------------
# Boundary queues: tq frames + per-channel seq + ack / replay
# ---------------------------------------------------------------------------
class _LocalChan:
    """In-process frame pipe (thread-safe), with the TCP chans' send /
    poll surface, so the endpoint logic is transport-agnostic."""

    def __init__(self, tx: _queue.Queue, rx: _queue.Queue):
        self._tx, self._rx = tx, rx

    def send(self, frame: dict) -> bool:
        self._tx.put(frame)
        return True

    def poll(self) -> List[dict]:
        out: List[dict] = []
        while True:
            try:
                out.append(self._rx.get_nowait())
            except _queue.Empty:
                return out


def _local_chan_pair() -> Tuple[_LocalChan, _LocalChan]:
    a, b = _queue.Queue(), _queue.Queue()
    return _LocalChan(a, b), _LocalChan(b, a)


class _SocketChan:
    """One end of a TCP boundary, one connection at a time. A reader thread
    drains the socket into a queue as frames arrive, so a peer's large
    frame never waits on this stage's compute or on its own send (the two
    ends of a boundary send 16 MB frames at each other: with reads only
    inside the stage's loop, both ``sendall`` s would wait on each other).
    Sends go out from the caller's thread through the transport's frame
    codec (``_send_on``: the chaos net fence, ``deadline_guard``). A
    replaced connection is surfaced as a ``_reconnect`` frame, so the
    endpoint replays its unacked tail."""

    def __init__(self):
        self._rx: _queue.Queue = _queue.Queue()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._gen = 0
        self._closed = False

    def _attach(self, sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(_transport._IO_TIMEOUT)
        with self._lock:
            old, self._sock = self._sock, sock
            self._gen += 1
            gen = self._gen
        if old is not None:
            _close(old)
        if gen > 1:
            self._rx.put({"t": "_reconnect"})
        threading.Thread(target=self._read, args=(sock, gen), daemon=True,
                         name=f"mpmd-chan-read-{gen}").start()

    def _read(self, sock: socket.socket, gen: int) -> None:
        decoder = _transport.FrameDecoder()
        while not self._closed:
            try:
                data = sock.recv(_transport._RECV_BYTES)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            for fr in decoder.feed(data):
                self._rx.put(fr)
        self._lost(gen)

    def _lost(self, gen: int) -> None:
        with self._lock:
            if gen != self._gen or self._sock is None:
                return
            sock, self._sock = self._sock, None
        _close(sock)
        self._on_lost()

    def _on_lost(self) -> None:
        """A dropped connection: the server end waits for the next accept,
        the client end redials."""

    def send(self, frame: dict) -> bool:
        with self._lock:
            sock, gen = self._sock, self._gen
        if sock is None:
            return False
        try:
            return _transport._send_on(sock, frame, "mpmd tq send")
        except OSError:
            self._lost(gen)
            return False

    def poll(self) -> List[dict]:
        out: List[dict] = []
        while True:
            try:
                out.append(self._rx.get_nowait())
            except _queue.Empty:
                return out

    def close(self) -> None:
        self._closed = True
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            _close(sock)


def _close(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _ServerChan(_SocketChan):
    """Downstream end of a TCP boundary: owns the listener; each accepted
    connection replaces the previous one (the peer redialed)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        with deadline_guard("mpmd tq listen"):
            self._listen.bind((host, port))
            self._listen.listen(4)
        self._listen.settimeout(_transport._IO_TIMEOUT)
        self._host, self._port = self._listen.getsockname()[:2]
        threading.Thread(target=self._accept, daemon=True,
                         name="mpmd-chan-accept").start()

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def _accept(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listen.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._attach(sock)

    def close(self) -> None:
        super().close()
        _close(self._listen)


class _ClientChan(_SocketChan):
    """Upstream end of a TCP boundary: dials the downstream listener, and
    redials with jittered backoff when the connection drops."""

    def __init__(self, addr: str, seed: int = 0):
        super().__init__()
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._jitter = random.Random((seed << 16) ^ int(port))
        self._dial()

    def _dial(self) -> None:
        backoff = _transport._BACKOFF_MIN
        t_end = time.monotonic() + _QUEUE_TIMEOUT
        while not self._closed:
            try:
                with deadline_guard("mpmd tq dial"):
                    sock = socket.create_connection(
                        self._addr, timeout=_transport._IO_TIMEOUT)
            except OSError:
                if time.monotonic() > t_end:
                    raise
                time.sleep(backoff * (0.5 + self._jitter.random()))
                backoff = min(2 * backoff, _transport._BACKOFF_MAX)
                continue
            self._attach(sock)
            return

    def _on_lost(self) -> None:
        if not self._closed:
            threading.Thread(target=self._redial, daemon=True,
                             name="mpmd-chan-redial").start()

    def _redial(self) -> None:
        try:
            self._dial()
        except OSError:
            pass  # the peer is gone: recv's deadline reports it


def _payload_nbytes(frame: dict) -> int:
    payload = frame.get("x", {})
    return sum(int(getattr(payload.get(k), "nbytes", 0))
               for k in ("x", "scale"))


class BoundaryEndpoint:
    """One side of a stage boundary: sends on one tq channel, receives on
    the other, over any chan with a send / poll surface.

    * outgoing frames carry per-channel seqs and stay in an unacked buffer
      until the peer's cumulative ``tq_ack`` covers them;
    * incoming frames dedup against the per-channel cursor: a retransmit
      of a consumed micro-batch is dropped, never re-applied;
    * a reconnect replays the whole unacked tail in seq order (idempotent
      by the receiver's dedup);
    * ``seek()`` fast-forwards the consume cursor after a restore.

    Every chan operation sits under ``deadline_guard``."""

    def __init__(self, chan, send_channel: str, recv_channel: str, *,
                 wire: str = "raw", timeout: Optional[float] = None):
        self._chan = chan
        self._send_ch = send_channel
        self._recv_ch = recv_channel
        self.wire = wire
        self._seqs = _transport.SeqChannels()
        self._unacked: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._need_replay = False
        self._timeout = _QUEUE_TIMEOUT if timeout is None else float(timeout)
        #: payload bytes this side sent (replays excluded)
        self.sent_bytes = 0

    # -- sender side --------------------------------------------------------
    def send(self, arr, *, mb: int, meta: Optional[dict] = None) -> int:
        """Queue one tensor (a torch tensor on any device, or a numpy
        array) for the peer; returns its seq."""
        meta = dict(meta or ())
        meta["mb"] = int(mb)
        seq = self._seqs.next_seq(self._send_ch)
        frame = _transport.encode_tq_frame(
            self._send_ch, seq, arr, wire=self.wire, meta=meta)
        self._unacked[seq] = frame
        with deadline_guard(f"mpmd tq send {self._send_ch}", self._timeout):
            if not self._chan.send(frame):
                self._need_replay = True
        n = _payload_nbytes(frame)
        self.sent_bytes += n
        _obs.inc("mpmd_boundary_bytes_total", n, channel=self._send_ch)
        return seq

    def unacked(self) -> int:
        return len(self._unacked)

    # -- receiver side ------------------------------------------------------
    def seek(self, seq: int) -> None:
        """Checkpoint-restore replay point: the consume cursor jumps to the
        last acked micro-batch's seq; older retransmits become duplicates."""
        self._seqs.seek(self._recv_ch, int(seq))

    def acked_watermark(self) -> int:
        """The next seq this side will consume (== the cumulative ack)."""
        return self._seqs.cursor(self._recv_ch)

    def _pump(self) -> None:
        with deadline_guard(f"mpmd tq poll {self._recv_ch}", self._timeout):
            frames = self._chan.poll()
        for fr in frames:
            t = fr.get("t")
            if t == "_reconnect":
                self._need_replay = True
            elif t == "tq" and fr.get("ch") == self._recv_ch:
                self._seqs.stash(self._recv_ch, int(fr["seq"]), fr)
            elif t == "tq_ack" and fr.get("ch") == self._send_ch:
                upto = int(fr["seq"])
                for s in [s for s in self._unacked if s <= upto]:
                    del self._unacked[s]
        if self._need_replay:
            if not self._unacked:
                self._need_replay = False
                return
            ok = True
            for fr in list(self._unacked.values()):
                with deadline_guard(
                        f"mpmd tq replay {self._send_ch}", self._timeout):
                    ok = self._chan.send(fr)
                if not ok:
                    break
            if ok:
                _obs.inc("mpmd_queue_replay_total", channel=self._send_ch)
                _obs.event("mpmd_queue_replay", channel=self._send_ch,
                           frames=len(self._unacked))
                self._need_replay = False

    def recv(self, *, timeout: Optional[float] = None
             ) -> Tuple[torch.Tensor, dict]:
        """The next in-order frame on the recv channel (bounded block) as a
        CPU tensor of the sender's dtype; sends the cumulative ack for it
        before returning."""
        limit = self._timeout if timeout is None else float(timeout)
        t_end = time.monotonic() + limit
        while True:
            fr = self._seqs.pop_next(self._recv_ch)
            if fr is not None:
                seq = int(fr["seq"])
                _, _, arr, meta = _transport.decode_tq_frame(fr)
                ack = _transport.encode_tq_ack(self._recv_ch, seq)
                with deadline_guard(
                        f"mpmd tq ack {self._recv_ch}", self._timeout):
                    self._chan.send(ack)  # best effort: the ack is cumulative
                name = fr["x"]["dtype"]
                return from_host(arr, name), (meta or {})
            if time.monotonic() > t_end:
                raise TimeoutError(
                    f"mpmd recv on {self._recv_ch!r} timed out after "
                    f"{limit:.0f}s: upstream stage dead or wedged")
            self._pump()
            time.sleep(0.0002)

    def close(self):
        close = getattr(self._chan, "close", None)
        if close is not None:
            close()


def local_boundary(bid: int, *, wire: str = "raw"
                   ) -> Tuple[BoundaryEndpoint, BoundaryEndpoint]:
    """(upstream, downstream) endpoints over in-process queues. Boundary
    ``bid`` connects stage bid -> bid + 1; activations ride ``act<bid>``,
    cotangents ``cot<bid>``."""
    up_chan, down_chan = _local_chan_pair()
    up = BoundaryEndpoint(up_chan, f"act{bid}", f"cot{bid}", wire=wire)
    down = BoundaryEndpoint(down_chan, f"cot{bid}", f"act{bid}", wire=wire)
    return up, down


def tcp_boundary(bid: int, *, wire: str = "raw"
                 ) -> Tuple[BoundaryEndpoint, BoundaryEndpoint]:
    """The same pair over a loopback TCP connection: frames cross the
    transport's length-prefixed codec; seq dedup and reconnect replay are
    live."""
    server_chan = _ServerChan()
    down = BoundaryEndpoint(server_chan, f"cot{bid}", f"act{bid}", wire=wire)
    client_chan = _ClientChan(server_chan.addr, seed=bid)
    up = BoundaryEndpoint(client_chan, f"act{bid}", f"cot{bid}", wire=wire)
    return up, down


# ---------------------------------------------------------------------------
# One stage
# ---------------------------------------------------------------------------
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MpmdStage:
    """One pipeline stage: a contiguous slice of the stack's blocks, a
    device subset, and its callables (see the module docstring):

    * ``fwd(x) -> y`` (non-last stages, no grad);
    * ``bwd(x, gy) -> dx``: the forward recomputed from ``x``, then the
      backward, the parameters' gradients accumulated into ``.grad``;
    * ``loss_grad(x, extra, inv_m) -> (loss, dx)`` (the last stage): the
      blocks, the head and ``loss_fn`` on the whole micro-batch, backward
      of ``loss * inv_m``.

    ``x`` is ``put_batch``'s list of row chunks, one per device (one chunk
    on the first device when the width does not divide the rows)."""

    def __init__(self, stage_id: int, blocks: Sequence[torch.nn.Module],
                 positions: Sequence[int], devices: Sequence, *,
                 run_block: Optional[Callable] = None,
                 head: Optional[torch.nn.Module] = None,
                 loss_fn: Optional[Callable] = None):
        self.stage_id = int(stage_id)
        self.blocks = list(blocks)
        self.positions = tuple(int(p) for p in positions)
        self._run_block = run_block or (lambda blk, x: blk(x))
        self.head = head
        self._loss_fn = loss_fn
        self.compile_count = 0
        self._programs: Dict[tuple, Callable] = {}
        self._replicas: Dict[torch.device, list] = {}
        self._set_devices(devices)

    # -- devices ------------------------------------------------------------
    def _set_devices(self, devices: Sequence) -> None:
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError(f"stage {self.stage_id} got an empty device "
                             "subset")
        self.devices = devices
        self.dp = len(devices)
        self.device = devices[0]
        # the stage's weights live on its first device (in place: the
        # caller's optimizer keeps the same parameter objects)
        for m in self.blocks + ([self.head] if self.head is not None
                                else []):
            m.to(self.device)
        self._replicas = {}

    def resize(self, devices: Sequence) -> None:
        """Stage-local width change: a new device subset, THIS stage's
        callables dropped; nothing else in the pipeline is touched."""
        old = self.dp
        self._set_devices(devices)
        self._programs.clear()
        _obs.event("mpmd_stage_resize", stage=self.stage_id, old_dp=old,
                   new_dp=self.dp)

    def parameters(self) -> List[torch.nn.Parameter]:
        ps = [p for b in self.blocks for p in b.parameters()]
        if self.head is not None:
            ps += list(self.head.parameters())
        return ps

    def begin_step(self) -> None:
        """Drop the weight copies of the devices past the first: the
        weights moved since the last step."""
        self._replicas = {}

    def put_batch(self, arr) -> List[torch.Tensor]:
        """A micro-batch's rows split over this stage's devices when the
        width divides them, else whole on the first device (a width that
        does not divide the rows cannot split them)."""
        t = torch.as_tensor(arr)
        if self.dp > 1 and t.dim() and t.shape[0] % self.dp == 0:
            return [c.to(d) for c, d in zip(t.chunk(self.dp), self.devices)]
        return [t.to(self.device)]

    def put_whole(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    # -- the blocks on a device ---------------------------------------------
    def _replica(self, dev: torch.device) -> list:
        """The stage's weights on ``dev`` (a device past the first): leaf
        copies, their gradients folded back by ``_fold_replica_grads``."""
        rep = self._replicas.get(dev)
        if rep is None:
            rep = []
            for blk in self.blocks:
                d = {n: p.detach().to(dev).requires_grad_(p.requires_grad)
                     for n, p in blk.named_parameters()}
                d.update({n: b.to(dev) for n, b in blk.named_buffers()})
                rep.append(d)
            self._replicas[dev] = rep
        return rep

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        if dev == self.device:
            for blk in self.blocks:
                x = self._run_block(blk, x)
            return x
        for blk, rep in zip(self.blocks, self._replica(dev)):
            x = torch.func.functional_call(blk, rep, (x,))
        return x

    def _fold_replica_grads(self) -> None:
        """Sum the gradients of the devices past the first into the
        weights' ``.grad`` on the first device."""
        for rep in self._replicas.values():
            for blk, d in zip(self.blocks, rep):
                for n, p in blk.named_parameters():
                    g = d[n].grad
                    if g is None:
                        continue
                    g = g.to(p.device)
                    p.grad = g if p.grad is None else p.grad.add_(g)
                    d[n].grad = None

    # -- callables ------------------------------------------------------------
    def _program(self, kind: str, shapes: tuple, build: Callable
                 ) -> Callable:
        key = (kind, shapes, self.dp)
        prog = self._programs.get(key)
        if prog is None:
            prog = build()
            self._programs[key] = prog
            self.compile_count += 1
            _obs.inc("mpmd_stage_compile_total", stage=self.stage_id,
                     program=kind, hit="false")
        return prog

    def _gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts])

    def fwd(self, x: List[torch.Tensor]) -> torch.Tensor:
        def build():
            def run(chunks):
                with torch.no_grad():
                    return self._gather([self._run(c) for c in chunks])
            return run

        return self._program("fwd", tuple(tuple(c.shape) for c in x),
                             build)(x)

    def bwd(self, x: List[torch.Tensor], gy: torch.Tensor) -> torch.Tensor:
        def build():
            def run(chunks, g):
                gs = g.split([c.shape[0] for c in chunks]) \
                    if len(chunks) > 1 else [g]
                dxs = []
                with torch.enable_grad():
                    for c, gc in zip(chunks, gs):
                        xc = c.detach().requires_grad_()
                        y = self._run(xc)
                        torch.autograd.backward(y, gc.to(y.device))
                        dxs.append(xc.grad)
                self._fold_replica_grads()
                return self._gather(dxs)
            return run

        return self._program(
            "bwd", (tuple(tuple(c.shape) for c in x), tuple(gy.shape)),
            build)(x, gy)

    def loss_grad(self, x: List[torch.Tensor], extra: tuple,
                  inv_m: float) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._loss_fn is None:
            raise ValueError("the last stage needs loss_fn")

        def build():
            def run(chunks, ex, inv):
                with torch.enable_grad():
                    xs = [c.detach().requires_grad_() for c in chunks]
                    h = self._gather([self._run(xc) for xc in xs])
                    if self.head is not None:
                        h = self.head(h)
                    loss = self._loss_fn(h, *ex)
                    torch.autograd.backward(loss * inv)
                self._fold_replica_grads()
                return loss.detach(), self._gather([xc.grad for xc in xs])
            return run

        return self._program(
            "loss_grad", (tuple(tuple(c.shape) for c in x),
                          tuple(tuple(e.shape) for e in extra)),
            build)(x, extra, inv_m)


# ---------------------------------------------------------------------------
# The pipeline driver
# ---------------------------------------------------------------------------
def _partition(n_items: int, n_parts: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) slices, the remainder spread from the front."""
    base, rem = divmod(n_items, n_parts)
    out, lo = [], 0
    for i in range(n_parts):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _default_devices(need: int) -> List[torch.device]:
    """The CUDA devices, or ``need`` times the CPU when the caller made the
    CPU the default device (``paddle.set_device("cpu")``)."""
    from ..device import resolve_device

    dev = resolve_device(None)
    if dev.type == "cpu":
        return [dev] * need
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class MpmdPipeline:
    """MPMD driver over an unpipelined ``SpmdPipeline``'s blocks.

    Construction copies no parameter: the stack's blocks (and an optional
    head) stay the single source of truth, so the caller's optimizer, the
    one the fold trains with, updates them. ``train_batch`` computes the
    whole loss MPMD-style and leaves the accumulated gradients on
    ``p.grad`` (replacing what was there, as ``loss.backward()`` after
    ``clear_grad`` would); the caller runs ``opt.step()`` as usual.

    ``widths`` picks each stage's width (unequal allowed; default
    ``PADDLE_TPU_MPMD_STAGES``, else 1 per stage of the stack's
    ``num_stages``); stage ``s`` takes the next ``widths[s]`` entries of
    ``devices``. ``layer_split`` gives explicit per-stage layer counts.
    V > 1 (interleaved virtual stages) stays on the SPMD path."""

    def __init__(self, spmd, widths: Optional[Sequence[int]] = None, *,
                 head=None, loss_fn: Optional[Callable] = None,
                 num_microbatches: Optional[int] = None,
                 schedule: str = "1f1b", transport: str = "local",
                 wire: Optional[str] = None, devices=None,
                 cache_dir: Optional[str] = None,
                 shard_dir: Optional[str] = None,
                 layer_split: Optional[Sequence[int]] = None):
        from .fleet.meta_parallel.pipeline_parallel import (
            PP_SCHEDULES, phased_stage_table)

        if cache_dir is not None:
            raise NotImplementedError(_CACHE_UNPORTED)
        if getattr(spmd, "num_virtual_stages", 1) != 1:
            raise ValueError("MPMD supports V=1 only; interleaved virtual "
                             "stages stay on the SPMD path")
        if getattr(spmd, "pipelined", False):
            raise ValueError(
                "MpmdPipeline drives an unpipelined SpmdPipeline (every "
                "block in this process); this one is split over a hybrid "
                "group's pipe ranks")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule={schedule!r}: MPMD runs "
                             f"'gpipe' or '1f1b' of {PP_SCHEDULES}")
        if transport not in ("local", "tcp"):
            raise ValueError(f"transport={transport!r}: 'local' or 'tcp'")
        widths = list(widths or parse_stage_widths() or
                      [1] * max(spmd.num_stages, 1))
        self._spmd = spmd
        self._table_fn = phased_stage_table
        self.schedule = schedule
        self.num_stages = len(widths)
        self.num_microbatches = int(num_microbatches or
                                    getattr(spmd, "num_microbatches", None)
                                    or 4)
        self.wire = resolve_wire(wire)
        self.transport = transport
        self.head = head
        self._loss_fn = loss_fn or (lambda y, *e: (y ** 2).mean())
        self.step_index = 0
        self.shard_dir = shard_dir
        self.last_step_stats: Dict[int, Dict[str, float]] = {}

        need = sum(widths)
        devices = [torch.device(d) for d in (
            devices if devices is not None else _default_devices(need))]
        if need > len(devices):
            raise ValueError(f"stage widths {widths} need {need} devices, "
                             f"have {len(devices)}")
        L = spmd.num_layers
        if layer_split is not None:
            # explicit per-stage layer COUNTS: an unbalanced stack puts more
            # layers on one stage and makes up for it with its width
            sizes = [int(n) for n in layer_split]
            if (len(sizes) != self.num_stages or any(n < 1 for n in sizes)
                    or sum(sizes) != L):
                raise ValueError(
                    f"layer_split={list(layer_split)} must be "
                    f"{self.num_stages} positive counts summing to {L}")
            self._slices, lo = [], 0
            for n in sizes:
                self._slices.append((lo, lo + n))
                lo += n
        else:
            if L < self.num_stages:
                raise ValueError(f"{L} layers cannot fill "
                                 f"{self.num_stages} stages")
            self._slices = _partition(L, self.num_stages)
        inv = spmd._inv_order
        self.stages: List[MpmdStage] = []
        dev_lo = 0
        for s, ((lo, hi), dp) in enumerate(zip(self._slices, widths)):
            last = s == self.num_stages - 1
            positions = [int(inv[l]) for l in range(lo, hi)]
            self.stages.append(MpmdStage(
                s, [spmd.blocks[p] for p in positions], positions,
                devices[dev_lo:dev_lo + dp], run_block=spmd._run_block,
                head=head if last else None,
                loss_fn=self._loss_fn if last else None))
            dev_lo += dp
        self._devices = devices
        self._build_boundaries()

    # -- boundaries ---------------------------------------------------------
    def _build_boundaries(self) -> None:
        make = tcp_boundary if self.transport == "tcp" else local_boundary
        self._up: List[BoundaryEndpoint] = []     # owned by stage i
        self._down: List[BoundaryEndpoint] = []   # owned by stage i + 1
        for i in range(self.num_stages - 1):
            up, down = make(i, wire=self.wire)
            self._up.append(up)
            self._down.append(down)

    def close(self) -> None:
        """Close the boundary connections (the TCP listeners)."""
        for ep in self._up + self._down:
            ep.close()

    def boundary_bytes(self) -> int:
        """Payload bytes sent over every boundary so far."""
        return sum(ep.sent_bytes for ep in self._up + self._down)

    # -- parameter plumbing -------------------------------------------------
    def parameters(self):
        ps = list(self._spmd.parameters())
        if self.head is not None:
            ps += list(self.head.parameters())
        return ps

    def compile_counts(self) -> Dict[int, int]:
        return {s.stage_id: s.compile_count for s in self.stages}

    def resize_stage(self, s: int, dp: int, devices=None) -> None:
        """Change ONE stage's width; every other stage keeps its devices
        and its callables. Without ``devices`` the stage keeps its first
        device and takes the rest from those no other stage holds (on a
        pool of one repeated device, that device)."""
        if devices is None:
            st = self.stages[s]
            taken = {d for o in self.stages if o.stage_id != s
                     for d in o.devices}
            pool = [st.device] + [d for d in self._devices
                                  if d not in taken and d != st.device]
            if len(set(self._devices)) == 1:
                pool = [st.device] * dp
            devices = pool[:dp]
        if len(devices) < dp:
            raise ValueError(f"resize_stage({s}, dp={dp}): only "
                             f"{len(devices)} free devices")
        self.stages[s].resize(devices[:dp])

    # -- one training step --------------------------------------------------
    def train_batch(self, x, y=None) -> float:
        """Forward + backward over every micro-batch through the stage
        runners; the accumulated gradients land on ``p.grad``, the loss is
        returned as a float."""
        t_step = time.perf_counter()
        M, S = self.num_microbatches, self.num_stages
        x = torch.as_tensor(x)
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"M={M} microbatches")
        mbs = x.chunk(M)
        ymbs = torch.as_tensor(y).chunk(M) if y is not None else None
        table = self._table_fn(S, 1, M, self.schedule)
        for st in self.stages:
            st.begin_step()
            for p in st.parameters():
                p.grad = None
        losses: Dict[int, torch.Tensor] = {}
        errors: List[BaseException] = []
        with _obs.span("mpmd_step", step=self.step_index, stages=S,
                       microbatches=M, schedule=self.schedule,
                       transport=self.transport, wire=self.wire):
            threads = [
                threading.Thread(
                    target=self._run_stage,
                    args=(s, table[s], mbs, ymbs, 1.0 / M, losses, errors),
                    name=f"mpmd-stage-{s}", daemon=True)
                for s in range(S)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=_QUEUE_TIMEOUT * 2)
            if any(t.is_alive() for t in threads):
                raise TimeoutError("mpmd stage runner wedged")
            if errors:
                raise errors[0]
        last = self.stages[-1].device
        loss = float(torch.stack([losses[m].to(last) for m in range(M)])
                     .sum() / M)
        self.step_index += 1
        _obs.observe("mpmd_step_seconds", time.perf_counter() - t_step)
        self.export_stage_stats()
        if self.shard_dir:
            self.save_shards(self.shard_dir)
        return loss

    def _run_stage(self, s, ops, mbs, ymbs, inv_m, losses, errors) -> None:
        try:
            st = self.stages[s]
            last = s == self.num_stages - 1
            up = self._up[s] if not last else None
            down = self._down[s - 1] if s > 0 else None
            stash: Dict[int, List[torch.Tensor]] = {}
            busy = 0.0
            t0 = time.perf_counter()
            for op_i, (_tick, kind, mb, _k) in enumerate(ops):
                chaos.mpmd_fence(s, op_i)
                if kind == "F":
                    if s == 0:
                        x_mb = st.put_batch(mbs[mb])
                    else:
                        arr, meta = down.recv()
                        if meta.get("mb") != mb:
                            raise RuntimeError(
                                f"stage {s} expected act mb={mb}, got "
                                f"{meta.get('mb')}: schedule skew")
                        x_mb = st.put_batch(arr)
                    stash[mb] = x_mb
                    if not last:
                        t1 = time.perf_counter()
                        y_mb = st.fwd(x_mb)
                        _sync(st.device)
                        busy += time.perf_counter() - t1
                        up.send(y_mb, mb=mb)
                else:  # "B"
                    x_mb = stash.pop(mb)
                    t1 = time.perf_counter()
                    if last:
                        ex = ((st.put_whole(ymbs[mb]),) if ymbs is not None
                              else ())
                        losses[mb], dx = st.loss_grad(x_mb, ex, inv_m)
                    else:
                        g, meta = up.recv()
                        if meta.get("mb") != mb:
                            raise RuntimeError(
                                f"stage {s} expected cot mb={mb}, got "
                                f"{meta.get('mb')}: schedule skew")
                        t1 = time.perf_counter()
                        dx = st.bwd(x_mb, st.put_whole(g))
                    _sync(st.device)
                    busy += time.perf_counter() - t1
                    if s > 0:
                        down.send(dx, mb=mb)
                _obs.inc("mpmd_tick_total", stage=s, kind=kind)
            wall = max(time.perf_counter() - t0, 1e-9)
            idle = max(0.0, 1.0 - busy / wall)
            self.last_step_stats[s] = {"busy_s": busy, "wall_s": wall,
                                       "idle_fraction": idle}
            _obs.set_gauge("mpmd_stage_idle_fraction", idle, stage=s)
        except BaseException as exc:  # noqa: BLE001 (raised by train_batch)
            errors.append(exc)

    def export_stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Publish the last step's per-stage busy / idle stats to the live
        telemetry plane (``observability/live.py``) so the fleet
        aggregator can watch stage imbalance while the job runs. The
        ``mpmd_stage_idle_fraction`` gauges export the same numbers
        post-hoc; this is the streaming hook. One env lookup when the live
        plane is off. Returns the exported mapping (stage id -> stats)."""
        stats = {str(s): rec for s, rec in self.last_step_stats.items()}
        from ..observability import live as _live

        _live.note_stage_stats(stats)
        return stats

    # -- per-stage checkpoint shards ----------------------------------------
    def _opt_index(self, optimizer) -> Dict[int, int]:
        if optimizer is None:
            return {}
        return {id(p): i for i, p in enumerate(optimizer._parameter_list)}

    def _stage_entries(self, st: MpmdStage):
        """``(key, parameter)`` of a stage: ``b{position}.{name}`` by the
        block's place in the stack, the head's ``h.{name}``."""
        for pos, blk in zip(st.positions, st.blocks):
            for n, p in blk.named_parameters():
                yield f"b{pos}.{n}", p
        if st.head is not None:
            for n, p in st.head.named_parameters():
                yield f"h.{n}", p

    def save_shards(self, base_dir: str, optimizer=None) -> None:
        """Each stage commits its own shard: its blocks' parameters (and
        their optimizer entries when given), the head in the last
        stage's, at ``step_index``."""
        from .fleet.elastic import save_stage_shard

        index = self._opt_index(optimizer)
        for st in self.stages:
            state: Dict[str, torch.Tensor] = {}
            for key, p in self._stage_entries(st):
                state[key] = p.detach()
                i = index.get(id(p))
                acc = optimizer._accumulators[i] if i is not None else None
                for k, v in (acc or {}).items():
                    if isinstance(v, torch.Tensor):
                        state[f"{key}.opt.{k}"] = v
            save_stage_shard(base_dir, st.stage_id, self.step_index, state)

    def restore_shards(self, base_dir: str, optimizer=None
                       ) -> Optional[int]:
        """Copy the parameters (and optimizer entries) of the newest step
        every stage committed into the live ones, in place; the queues
        restart clean, since a restored step replays from its first
        micro-batch. Returns the restored step, or None when nothing was
        committed."""
        from .fleet.elastic import latest_common_step, load_stage_shard

        step = latest_common_step(base_dir, self.num_stages)
        if step is None:
            return None
        index = self._opt_index(optimizer)
        with torch.no_grad():
            for st in self.stages:
                shard = load_stage_shard(base_dir, st.stage_id, step)
                for key, p in self._stage_entries(st):
                    p.copy_(torch.as_tensor(shard[key]).to(p.device))
                    i = index.get(id(p))
                    if i is None:
                        continue
                    acc = optimizer._init_state(p)
                    found = False
                    for k, v in acc.items():
                        if f"{key}.opt.{k}" in shard and isinstance(
                                v, torch.Tensor):
                            acc[k] = torch.as_tensor(
                                shard[f"{key}.opt.{k}"]).to(v.device,
                                                            v.dtype).clone()
                            found = True
                    if found:
                        optimizer._accumulators[i] = acc
                        optimizer._master.pop(i, None)
        self.step_index = step
        return step
