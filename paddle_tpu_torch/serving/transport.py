"""Streaming dataplane: persistent router <-> worker sockets (counterpart
of ``paddle_tpu/serving/transport.py``: the same frames, the same bytes on
the wire for the same frame).

On the store dataplane every dispatch and every completion pays several
coordination-store round trips. This module moves the DATA onto direct
TCP connections and demotes the store to what it is good at — membership
and failover ground truth.

One difference from the reference's receive loop: a frame that has
started arriving is read to its end before the poll returns (see
``_drain_sock``), so a KV frame of a long prompt crosses in one poll.

Tensors on the wire are numpy arrays. numpy has no bfloat16, so the port
carries a bf16 slab (a bf16 KV pool's pages, a bf16 tensor-queue payload)
as its raw 16-bit words (``tensor.view(torch.int16)``) with a dtype tag
(``framework.dtype.to_host`` / ``from_host``): the ``raw`` wire stays
bit-equal, and nothing on either end needs ``ml_dtypes``.

Wire format: length-prefixed pickled frames (``struct.pack(">I", n)`` +
``protocol.pack``; the store wire already trusts same-job pickles, this
is the same trust domain over a different socket). Frames are dicts with
a ``t`` tag:

    hello     {"t","peer","name"}            connection identification
    dispatch  {"t","reqs":[rec,...]}         batched request records; each
                                             rec carries its engine-stream
                                             ``seq`` so the worker consumes
                                             in order and duplicates
                                             (retransmits) are skipped
    occ       {"t","occ":{...},"ts"}         occupancy beat riding the same
                                             connection (heartbeat)
    done      {"t","recs":[...]}             completed token streams; ALWAYS
                                             written to the store first
                                             (done-before-ack invariant)
    stream    {"t","updates":[(rid,n)],"ts"} incremental token counts
    relay     {"t","rids":[...]}             prefill->router: KV pages of
                                             these rids were handed to their
                                             decode engine
    kv        {"t","rid","rec",...}          prefill->decode KV-page stream
                                             (``encode_kv``/``decode_kv``)
    tq        {"t","ch","seq","x",...}       generic tensor-queue frame: one
                                             tensor on named channel ``ch``
                                             (MPMD inter-stage activations/
                                             cotangents ride these)
    tq_ack    {"t","ch","seq"}               receiver consumed everything on
                                             ``ch`` up to and incl. ``seq``
                                             (sender drops its replay copy)
    wt        {"t","ch","seq","kind",...}    online weight-epoch stream
                                             (trainer -> engine): ``begin``
                                             opens epoch E's shadow set,
                                             ``leaf`` carries one named
                                             weight leaf (encode_tensor,
                                             bf16 wire by default), ``swap``
                                             orders the pointer-swap promote,
                                             ``discard`` drops an un-promoted
                                             shadow (rollback). Seq-acked
                                             and consumed in order per
                                             channel like dispatch records
    wt_ack    {"t","ch","seq","epoch",..}    receiver consumed the wt frame
                                             with that seq; a swap ack's
                                             ``applied`` reports whether the
                                             promote actually flipped (False
                                             = already at/past that epoch,
                                             the exactly-once no-op)
    tele      {"t","pays":[...]}             live-telemetry batches riding the
                                             occupancy beat: each payload is
                                             (src, seq)-numbered and re-sent
                                             for a few beats, so the router's
                                             aggregator dedups duplicates and
                                             a chaos-dropped frame is healed
                                             by the next beat (advisory plane:
                                             loss never blocks the request
                                             path — see observability/live.py)

Seq namespaces are PER CHANNEL, not per connection. Dispatch records
and tensor-queue frames interleave on one socket, each stream numbering
its own frames from 0 — a shared per-connection counter would make the
receiver's dedup cursor treat channel B's seq 0 as a stale duplicate of
channel A's. ``SeqChannels`` keeps one send counter and one in-order
dedup cursor per channel name; the worker's dispatch stream is channel
``"dispatch"``, MPMD boundaries use ``act<i>``/``cot<i>``.

Failure model: frames are best-effort; a lost ``dispatch`` is retransmitted
by the router when the worker's acked_seq stalls (idempotent — workers skip
seqs already consumed), a lost ``done``/``occ`` is recovered from the store
ground truth, and a lost ``kv`` falls back to router failover (re-dispatch
reruns the prefill bit-equal, seeds are explicit). Reconnects use jittered
exponential backoff so a restarted worker is not dialed in lockstep.

Every socket send/recv sits under ``protocol.deadline_guard``, as store
ops do. Chaos (PADDLE_CHAOS_NET_MODE) injects drop/half_open/latency
faults at the send fences.

This module is the single writer of the ``serving_transport_*`` metric
family.
"""
from __future__ import annotations

import select
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import observability as _obs
from ..framework.dtype import convert_dtype, from_host, to_host
from ..testing import chaos
from .protocol import deadline_guard, pack, unpack

__all__ = [
    "TransportServer", "TransportClient", "FrameDecoder", "SeqChannels",
    "encode_frame", "encode_kv", "decode_kv",
    "encode_tensor", "decode_tensor",
    "encode_tq_frame", "decode_tq_frame", "encode_tq_ack",
    "encode_wt_frame", "decode_wt_frame", "encode_wt_ack",
]

_HDR = struct.Struct(">I")

#: per-process frame-send counter, the chaos net_fence index — a soak can
#: target "the Nth frame this process sends" deterministically
_send_index = 0

#: jittered-backoff bounds for client redials (seconds)
_BACKOFF_MIN = 0.05
_BACKOFF_MAX = 2.0

#: blocking-op timeout: sends and dials must fail fast, the deadline
#: guard above them is the watchdog of last resort
_IO_TIMEOUT = 5.0

#: bytes a receive asks the socket for at once
_RECV_BYTES = 1 << 20


def encode_frame(frame: dict) -> bytes:
    """Length-prefixed pickled frame, ready for one sendall."""
    payload = pack(frame)
    return _HDR.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental decoder: feed raw bytes, get whole frames out."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[dict]:
        self._buf.extend(data)
        frames = []
        while True:
            if len(self._buf) < _HDR.size:
                return frames
            (n,) = _HDR.unpack(self._buf[:_HDR.size])
            if len(self._buf) < _HDR.size + n:
                return frames
            with memoryview(self._buf) as view:
                payload = bytes(view[_HDR.size:_HDR.size + n])
            del self._buf[:_HDR.size + n]
            frames.append(unpack(payload))

    def partial(self) -> bool:
        """True while a frame has started arriving but is not whole."""
        return bool(self._buf)


def _count(direction: str, kind: str, nbytes: int):
    _obs.inc("serving_transport_frames_total", dir=direction, kind=kind)
    _obs.inc("serving_transport_bytes_total", nbytes, dir=direction)


def _observe_latency(frame: dict):
    """Wire latency of heartbeat-class frames that carry a send wall
    clock (occ/stream) — the streaming dataplane's transit histogram.
    Wall-to-wall, so host clock skew shifts it like srv_net_transit."""
    ts = frame.get("ts")
    if isinstance(ts, (int, float)):
        _obs.observe("serving_transport_stream_seconds",
                     max(time.time() - float(ts), 0.0))


def _send_on(raw_sock, frame: dict, what: str) -> bool:
    """Send one frame on a connected socket; chaos net fence first.
    Returns True when the frame was delivered to the kernel (half_open
    pretends success — the silently-swallowed-frame fault). Raises
    OSError on a dead peer (and ConnectionError on a chaos drop) so the
    caller can tear down and reconnect."""
    global _send_index
    idx = _send_index
    _send_index += 1
    action = chaos.net_fence(idx)
    if action == "half_open":
        return True  # swallowed: peer never sees it, sender thinks it did
    if action == "drop":
        raise ConnectionResetError("chaos net_drop severed the connection")
    data = encode_frame(frame)
    with deadline_guard(what):
        raw_sock.sendall(data)
    _count("send", str(frame.get("t")), len(data))
    return True


def _drain_sock(raw_sock, decoder: FrameDecoder, what: str,
                whole_frames: bool = False) -> Optional[List[dict]]:
    """Read everything currently available; None means the peer closed
    (or errored) and the connection must be dropped.

    With ``whole_frames`` (the worker's listener) a frame that has started
    arriving is read to its end, waiting up to ``_IO_TIMEOUT`` for each
    next piece (a sender stalled that long mid-frame is dropped): a KV
    frame of a long prompt is ~120 MB at a 1.3B model's widths, and reading
    only what one poll finds buffered would stretch it over hundreds of
    polls, past the sender's send timeout. Without it (the router's and
    the prefill worker's links) the read never waits, as the reference's:
    a peer stalled mid-frame cannot hold up the caller's loop."""
    frames: List[dict] = []
    while True:
        with deadline_guard(what):
            wait = _IO_TIMEOUT if whole_frames and decoder.partial() else 0.0
            ready, _, _ = select.select([raw_sock], [], [], wait)
            if not ready:
                if wait:
                    return None  # the peer stalled mid-frame
                break
            try:
                data = raw_sock.recv(_RECV_BYTES)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return None
        if not data:
            return None
        for fr in decoder.feed(data):
            _count("recv", str(fr.get("t")), 0)
            _observe_latency(fr)
            frames.append(fr)
    return frames


class TransportServer:
    """Worker-side listener: accepts router/peer connections, drains
    frames from all of them, and can address replies by connection id."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        listen_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listen_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        with deadline_guard("transport listen"):
            listen_sock.bind((host, port))
            listen_sock.listen(16)
        listen_sock.setblocking(False)
        self._listen_sock = listen_sock
        self._host, self._port = listen_sock.getsockname()[:2]
        self._conns: Dict[int, socket.socket] = {}
        self._decoders: Dict[int, FrameDecoder] = {}
        self._next_conn = 0

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def conn_ids(self) -> List[int]:
        return list(self._conns)

    def _accept(self):
        while True:
            with deadline_guard("transport accept"):
                try:
                    conn_sock, _ = self._listen_sock.accept()
                except (BlockingIOError, InterruptedError):
                    return
                except OSError:
                    return
            conn_sock.settimeout(_IO_TIMEOUT)
            conn_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            cid = self._next_conn
            self._next_conn += 1
            self._conns[cid] = conn_sock
            self._decoders[cid] = FrameDecoder()

    def poll(self) -> List[Tuple[int, dict]]:
        """Accept pending connections and drain every readable one.
        Returns (conn_id, frame) pairs in arrival order per connection."""
        self._accept()
        out: List[Tuple[int, dict]] = []
        for cid in list(self._conns):
            frames = _drain_sock(self._conns[cid], self._decoders[cid],
                                 "transport recv", whole_frames=True)
            if frames is None:
                self._drop(cid)
                continue
            out.extend((cid, fr) for fr in frames)
        return out

    def send(self, conn_id: int, frame: dict) -> bool:
        """Best-effort send to one connection; a dead peer drops the
        connection and returns False (the router ground-truths through
        the store, so nothing is lost — only late)."""
        conn_sock = self._conns.get(conn_id)
        if conn_sock is None:
            return False
        try:
            return _send_on(conn_sock, frame, "transport send")
        except OSError:
            self._drop(conn_id)
            return False

    def _drop(self, conn_id: int):
        conn_sock = self._conns.pop(conn_id, None)
        self._decoders.pop(conn_id, None)
        if conn_sock is not None:
            try:
                conn_sock.close()
            except OSError:
                pass

    def close(self):
        for cid in list(self._conns):
            self._drop(cid)
        try:
            self._listen_sock.close()
        except OSError:
            pass


class TransportClient:
    """Dialer side (router->worker, prefill->decode): one persistent
    connection with jittered-backoff reconnect. ``send``/``poll`` never
    raise on a dead peer — they fail soft and schedule a redial, because
    liveness decisions belong to the router's beat-staleness failover,
    not to the transport."""

    def __init__(self, addr: str, seed: int = 0):
        host, port = addr.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._sock: Optional[socket.socket] = None
        self._decoder = FrameDecoder()
        # deterministic jitter stream per client (seeded by the target
        # port by default) so backoff schedules are reproducible in soaks
        import random as _random
        self._jitter = _random.Random((seed << 16) ^ self._port)
        self._backoff = _BACKOFF_MIN
        self._next_dial = 0.0
        self.reconnects = 0
        self._ever_connected = False
        self._dial()

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def connected(self) -> bool:
        return self._sock is not None

    def _dial(self) -> bool:
        now = time.monotonic()
        if now < self._next_dial:
            return False
        try:
            with deadline_guard("transport dial"):
                dial_sock = socket.create_connection(
                    (self._host, self._port), timeout=_IO_TIMEOUT)
            dial_sock.settimeout(_IO_TIMEOUT)
            dial_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = dial_sock
            self._decoder = FrameDecoder()
            self._backoff = _BACKOFF_MIN
            if self._ever_connected:
                self.reconnects += 1
                _obs.inc("serving_transport_reconnect_total")
            self._ever_connected = True
            return True
        except OSError:
            # jittered exponential backoff: reconnect storms from a fleet
            # of routers must not land on a restarted worker in lockstep
            delay = self._backoff * (0.5 + self._jitter.random())
            self._backoff = min(self._backoff * 2.0, _BACKOFF_MAX)
            self._next_dial = now + delay
            self._sock = None
            return False

    def _teardown(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._next_dial = 0.0  # redial immediately on the next op

    def send(self, frame: dict) -> bool:
        if self._sock is None and not self._dial():
            return False
        try:
            return _send_on(self._sock, frame, "transport send")
        except OSError:
            self._teardown()
            return False

    def poll(self) -> List[dict]:
        if self._sock is None:
            self._dial()
            return []
        frames = _drain_sock(self._sock, self._decoder, "transport recv")
        if frames is None:
            self._teardown()
            return []
        return frames

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None


# ---------------------------------------------------------------------------
# KV-page wire codec
# ---------------------------------------------------------------------------

def _quantize(x, name, axis):
    """``(q int8, scale f32)`` numpy arrays of host slab ``x`` (dtype name
    ``name``) through the gradient wire's ``quantize_absmax``."""
    from ..distributed.grad_comm import quantize_absmax

    q, scale = quantize_absmax(from_host(x, name), axis=axis)
    return q.numpy(), scale.numpy()


def _dequantize(q, scale) -> np.ndarray:
    from ..distributed.grad_comm import dequantize_absmax

    return dequantize_absmax(torch.from_numpy(np.asarray(q)),
                             torch.from_numpy(np.asarray(scale))).numpy()


def encode_kv(k, v, wire: str, k_scale=None, v_scale=None,
              dtype: Optional[str] = None) -> dict:
    """Encode exported KV pages ``[L, n, Hkv, P, D]`` for the wire.

    ``k`` / ``v`` are host numpy arrays (or torch tensors); ``dtype`` names
    their dtype when they are a bf16 pool's 16-bit words (int16 arrays, as
    ``DecodeEngine.prefill_export`` gives them with ``"dtype":
    "bfloat16"``), else the arrays' own dtype is the tag.

    ``raw`` ships the pool bytes untouched (bit-equal contract; an int8
    POOL's pages travel with their scale slabs, still bit-equal). ``int8``
    quantizes f32/bf16 pages with one absmax scale per ``[layer, page,
    head]`` (axis=(-2,-1) — the whole page row of a head shares a scale)
    via the same ``quantize_absmax`` the dp gradient wire uses. Pages
    already int8 (int8 pool) pass through raw — re-quantizing quantized
    bytes only loses bits.
    """
    if wire not in ("raw", "int8"):
        raise ValueError(f"kv wire must be raw|int8, got {wire!r}")
    k, name = to_host(k)
    v, _ = to_host(v)
    name = dtype or name
    if wire == "int8" and name != "int8":
        qk, sk = _quantize(k, name, (-2, -1))
        qv, sv = _quantize(v, name, (-2, -1))
        return {"wire": "int8", "dtype": name, "k": qk, "v": qv,
                "k_scale": sk, "v_scale": sv}
    payload = {"wire": "raw", "dtype": name, "k": k, "v": v}
    if k_scale is not None:
        payload["k_scale"] = np.asarray(to_host(k_scale)[0], np.float32)
        payload["v_scale"] = np.asarray(to_host(v_scale)[0], np.float32)
    return payload


def decode_kv(payload: dict) -> dict:
    """Inverse of ``encode_kv``: raw passes through bit-identical;
    int8-wire dequantizes to float32. Returns ``{"k", "v", "dtype"}`` (+
    pool scale slabs for raw int8-pool pages); ``dtype`` tags the slabs
    (``"bfloat16"``: int16 words of a bf16 pool)."""
    if payload["wire"] == "int8":
        return {"k": _dequantize(payload["k"], payload["k_scale"]),
                "v": _dequantize(payload["v"], payload["v_scale"]),
                "dtype": "float32"}
    out = {"k": payload["k"], "v": payload["v"],
           "dtype": payload.get("dtype", np.asarray(payload["k"]).dtype.name)}
    if "k_scale" in payload:
        out["k_scale"] = payload["k_scale"]
        out["v_scale"] = payload["v_scale"]
    return out


# ---------------------------------------------------------------------------
# Per-channel seq namespaces (shared by dispatch + tensor-queue streams)
# ---------------------------------------------------------------------------

class SeqChannels:
    """Per-channel seq namespaces for one frame stream.

    One instance serves both directions of a connection: ``next_seq(ch)``
    numbers outgoing frames per channel, ``stash(ch, seq, item)`` dedups
    incoming ones against a per-channel in-order cursor, and
    ``pop_next(ch)`` consumes in seq order. Channels never see each
    other's counters, so interleaved streams (dispatch records next to
    tensor-queue frames) cannot false-dedup — the bug a single
    per-connection namespace bakes in.
    """

    def __init__(self):
        self._next_send: Dict[str, int] = {}
        self._cursor: Dict[str, int] = {}
        self._stash: Dict[str, Dict[int, object]] = {}

    # -- sender side --------------------------------------------------------
    def next_seq(self, channel: str) -> int:
        n = self._next_send.get(channel, 0)
        self._next_send[channel] = n + 1
        return n

    # -- receiver side ------------------------------------------------------
    def cursor(self, channel: str) -> int:
        """Next seq this side will consume on ``channel`` — doubles as the
        ack watermark (everything below it has been consumed)."""
        return self._cursor.get(channel, 0)

    def seek(self, channel: str, seq: int):
        """Fast-forward the consume cursor (checkpoint restore: replay
        starts at the last acked microbatch, not at zero)."""
        self._cursor[channel] = int(seq)
        stash = self._stash.get(channel)
        if stash:
            for s in [s for s in stash if s < seq]:
                del stash[s]

    def stash(self, channel: str, seq: int, item) -> bool:
        """Admit an incoming item; False = duplicate (retransmit of an
        already-consumed or already-stashed seq on THIS channel)."""
        seq = int(seq)
        if seq < self.cursor(channel):
            return False
        stash = self._stash.setdefault(channel, {})
        if seq in stash:
            return False
        stash[seq] = item
        return True

    def pop_next(self, channel: str):
        """In-order consume: the item at the cursor, advancing it — or
        None when the next seq has not arrived yet."""
        stash = self._stash.get(channel)
        if not stash:
            return None
        cur = self.cursor(channel)
        if cur not in stash:
            return None
        self._cursor[channel] = cur + 1
        return stash.pop(cur)

    def advance(self, channel: str):
        """Advance the cursor past an item consumed out-of-band (the
        worker's store-mirror fallback delivers the same stream through
        the store when a socket frame was lost)."""
        self._cursor[channel] = self.cursor(channel) + 1

    def drop(self, channel: str):
        """Forget a channel entirely — stash, cursor, and send counter.
        For per-connection channels (``wt:<cid>``) whose peer died: the
        stashed items can never be consumed (their publisher's unacked
        frames die with it) and a reconnect is a NEW cid, so keeping the
        namespace only leaks memory."""
        self._stash.pop(channel, None)
        self._cursor.pop(channel, None)
        self._next_send.pop(channel, None)

    def pending(self, channel: str) -> int:
        return len(self._stash.get(channel, ()))


# ---------------------------------------------------------------------------
# Generic tensor-queue frames (MPMD inter-stage activation/cotangent wire)
# ---------------------------------------------------------------------------

#: tensor wire formats: ``raw`` ships dtype bytes untouched (bit-equal),
#: ``bf16`` halves f32 payloads, ``int8`` absmax-quantizes like the dp
#: gradient wire. Resolution mirrors grad_comm/mp_comm wire grammar.
TENSOR_WIRES = ("raw", "f32", "bf16", "int8")


def encode_tensor(arr, wire: str = "raw") -> dict:
    """One tensor (numpy array or torch tensor) as a wire payload.
    ``raw``/``f32`` are bit-equal (the trajectory-equality contract rides
    on that); ``bf16`` halves f32 payloads (carried as bf16 words);
    ``int8`` carries one absmax scale per trailing row (axis=-1), the
    gradient wire's granularity."""
    if wire not in TENSOR_WIRES:
        raise ValueError(f"tensor wire must be one of {TENSOR_WIRES}, "
                         f"got {wire!r}")
    arr, name = to_host(arr)
    if wire == "int8" and name != "int8":
        q, scale = _quantize(arr, name, -1)
        return {"wire": "int8", "dtype": name, "x": q, "scale": scale}
    if wire == "bf16" and name == "float32":
        words, _ = to_host(torch.from_numpy(arr).to(torch.bfloat16))
        return {"wire": "bf16", "dtype": name, "x": words}
    return {"wire": "raw", "dtype": name, "x": arr}


def decode_tensor(payload: dict) -> np.ndarray:
    """Inverse of ``encode_tensor``: back to the source dtype (a bf16
    source comes back as its int16 words; ``from_host(out, "bfloat16")``
    makes it a tensor again)."""
    wire = payload["wire"]
    if wire == "int8":
        out = torch.from_numpy(_dequantize(payload["x"], payload["scale"]))
        return to_host(out.to(convert_dtype(payload["dtype"])))[0]
    if wire == "bf16":
        out = from_host(payload["x"], "bfloat16").float()
        return out.numpy().astype(payload["dtype"])
    return payload["x"]


def encode_tq_frame(channel: str, seq: int, arr: np.ndarray,
                    wire: str = "raw", meta: Optional[dict] = None) -> dict:
    """Tensor-queue frame: channel-scoped seq + encoded tensor. ``meta``
    carries small scheduling facts (microbatch index, step) the receiver
    needs without decoding the payload."""
    frame = {"t": "tq", "ch": channel, "seq": int(seq),
             "x": encode_tensor(arr, wire)}
    if meta:
        frame["meta"] = meta
    return frame


def decode_tq_frame(frame: dict) -> Tuple[str, int, np.ndarray, dict]:
    return (frame["ch"], int(frame["seq"]), decode_tensor(frame["x"]),
            frame.get("meta") or {})


def encode_tq_ack(channel: str, seq: int) -> dict:
    """Cumulative ack: everything on ``channel`` up to and including
    ``seq`` was consumed — the sender may drop its replay copies."""
    return {"t": "tq_ack", "ch": channel, "seq": int(seq)}


# ---------------------------------------------------------------------------
# Online weight-epoch frames (serving/online.py trainer -> engine wire)
# ---------------------------------------------------------------------------

#: wt frame kinds, in protocol order: ``begin`` opens the shadow set,
#: ``leaf`` frames stream the delta, ``swap`` promotes (commit side),
#: ``discard`` drops the shadow (rollback side)
WT_KINDS = ("begin", "leaf", "swap", "discard")


def encode_wt_frame(channel: str, seq: int, kind: str, epoch: int,
                    name: Optional[str] = None, arr=None,
                    wire: str = "bf16",
                    meta: Optional[dict] = None) -> dict:
    """One weight-stream frame. ``leaf`` frames carry the named tensor (a
    torch tensor or a host array; a bf16 one goes raw, as its words)
    through ``encode_tensor`` (bf16 wire by default — the absmax
    machinery handles int8); control kinds (begin/swap/discard) carry
    only the epoch. ``meta`` rides small facts the receiver wants
    without decoding the payload (leaf count, restore spec)."""
    if kind not in WT_KINDS:
        raise ValueError(f"wt kind must be one of {WT_KINDS}, got {kind!r}")
    frame = {"t": "wt", "ch": channel, "seq": int(seq), "kind": kind,
             "epoch": int(epoch)}
    if kind == "leaf":
        if name is None or arr is None:
            raise ValueError("wt leaf frames need name and arr")
        frame["name"] = str(name)
        frame["x"] = encode_tensor(
            arr if isinstance(arr, torch.Tensor) else np.asarray(arr), wire)
    if meta:
        frame["meta"] = meta
    return frame


def decode_wt_frame(frame: dict):
    """-> (kind, epoch, name, arr, meta); name/arr are None for control
    kinds."""
    kind = frame["kind"]
    arr = decode_tensor(frame["x"]) if kind == "leaf" else None
    return (kind, int(frame["epoch"]), frame.get("name"), arr,
            frame.get("meta") or {})


def encode_wt_ack(channel: str, seq: int, epoch: int,
                  applied: Optional[bool] = None,
                  kind: Optional[str] = None,
                  live: Optional[int] = None) -> dict:
    """Per-frame ack (NOT cumulative — the publisher journals stream
    progress fence by fence): the wt frame with ``seq`` was consumed.

    ``kind`` echoes the acked frame's kind so the publisher can tell a
    swap ack from a begin/leaf/discard ack. ``applied`` semantics are
    per kind:

    * ``begin``   True = shadow opened; False = epoch not newer than
      live (replay of a committed epoch)
    * ``leaf``    True = staged into the open shadow; False = dropped
      (no matching shadow — replay, or rolled back)
    * ``swap``    True = the promote flipped the epoch; False = the
      exactly-once no-op (engine at/past the epoch, or no shadow)
    * ``discard`` True = a shadow was dropped; False = nothing open

    Only ``live`` — the engine's serving epoch AFTER the frame was
    applied — proves what the engine serves: a begin/leaf/discard ack
    carries the pre-flip epoch there, so no ack kind can claim a flip
    that has not happened (see OnlineCoordinator._wait_acks)."""
    ack = {"t": "wt_ack", "ch": channel, "seq": int(seq),
           "epoch": int(epoch)}
    if applied is not None:
        ack["applied"] = bool(applied)
    if kind is not None:
        ack["kind"] = str(kind)
    if live is not None:
        ack["live"] = int(live)
    return ack
