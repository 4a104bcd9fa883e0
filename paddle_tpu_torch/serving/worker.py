"""Engine worker: one DecodeEngine behind the streaming dataplane
(counterpart of ``paddle_tpu/serving/worker.py``).

Registers in the coordination store under the serving namespace (a
race-free index from the atomic ``add`` counter) — the registration
record carries the worker's transport listen address, its ``role``
(``unified`` | ``prefill`` | ``decode``) and its KV wire codec — then
loops: drain dispatched requests (direct ``dispatch`` frames from the
router's persistent socket, with the legacy store keys as the A/B and
socket-failure fallback), advance the scheduler one step (with a chaos
``engine_fence`` so soaks can SIGKILL it mid-decode), publish finished
token streams, and publish an occupancy beat. Occupancy rides the SAME
socket as the data (the heartbeat) and is mirrored to the store at a
slow cadence — the store stays the membership/failover ground truth,
but per-request latency no longer pays store round trips.

Roles (disaggregated prefill/decode):

* ``unified`` — classic worker: local prefill + decode per request.
* ``prefill`` — dispatch records arrive with a ``kv_to`` target; the
  worker runs ``engine.prefill_export`` and streams the finished KV
  pages (``transport.encode_kv``) straight to the target decode worker,
  then tells the router via a ``relay`` frame. It never decodes.
* ``decode`` — imports streamed KV pages (``engine.try_import_prefill``,
  bit-equal to a local prefill on the raw wire) and decodes; it also
  accepts direct dispatches (short prompts skip disaggregation).

Crash-safety ordering is UNCHANGED from the store dataplane: a request's
``done`` key is written to the STORE before the occupancy beat that acks
it — wire ``done`` frames are a latency optimization on top, not the
ground truth — so failover can harvest everything a dead engine
finished; anything not harvested is re-run bit-equal (the router assigns
every request an explicit sampling seed — the engine's implicit
per-request default would differ across engines).

Run standalone, one process per worker, against the router's store::

    python -m paddle_tpu_torch.serving.worker --master 127.0.0.1:29510 \
        --device cuda --model-seed 7 --hidden 2048 --layers 24 \
        --heads 16 --vocab 50304 --max-positions 2048 --kv-dtype bf16

``--device`` (default ``cuda``) and ``--amp-dtype`` are the flags the
reference lacks; a worker asked for CUDA where there is none exits
non-zero. ``--amp-dtype bfloat16`` serves the model ``amp.decorate``d O2
(bf16 parameters and activations), the port's own extension. After its first
result and at the router's stop broadcast the worker prints one JSON line
on stderr (``{"serving_worker": {...}}``): its name, its device, its K3
launches by regime so far and its float32 matmul settings.

``--mp N`` (N > 1) serves one engine sharded over N ranks (the engine's
``dp 1 x mp N`` mesh: each rank holds ``Hkv / N`` kv heads and a block of
the vocab). The process started is rank 0: it holds the transport,
registers ONE engine in the store and runs the scheduler; it starts the
``N - 1`` follower ranks itself (``python -m paddle_tpu_torch.serving.
worker`` again, on the same device, with ``PADDLE_SERVING_MP_RANK`` set),
and the ranks form a gloo group over a ``file://`` rendezvous. Rank 0
hands every engine call that changes state (submit, prefill export, KV
import, step, warmup) to the followers, pickled on their stdin, before it
makes the call itself, so every rank runs the same programs; at the stop
broadcast it tells them to stop. A follower that dies ends rank 0 with a
non-zero exit (checked at every step and every hand-off); a follower
whose stdin closes (rank 0 died) exits. Each follower prints its own
``{"serving_worker_follower": {...}}`` line (its rank and K3 launches) on
the shared stderr when it stops. An exported KV frame carries every kv
head (gathered over the ranks) and an imported one is split over them,
so an mp-N prefill worker feeds an mp-1 decode worker unchanged.

``wt`` frames (``serving/online.py``'s weight epochs) are stashed by
publisher connection and applied in seq order between engine steps, a
few a poll (``_WT_FRAMES_PER_POLL``), each acked to its publisher; at
``--mp > 1`` the engine calls they make reach the followers as every
other state-changing call does. Under ``PADDLE_TPU_LIVE_TELEMETRY=1``
a worker with router links ships ``tele`` frames of its span tail on the
occupancy beat (``observability/live.py``).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

from .. import observability as _obs
from ..observability import live as _live
from ..inference.engine import DecodeEngine, EngineConfig, SamplingParams
from ..testing import chaos
from .protocol import (DEFAULT_NAMESPACE, ROLES, deadline_guard, k_ctl,
                       k_ctl_engine, k_done, k_engine, k_occ, k_req,
                       k_count, pack, unpack)
from .transport import (SeqChannels, TransportClient, TransportServer,
                        decode_kv, encode_kv)

__all__ = ["EngineWorker", "main"]

#: store-mirror cadence for occupancy/fallback drains once a router
#: socket is attached (the wire is the hot path; the store is failover
#: ground truth and only needs a slow heartbeat)
_STORE_MIRROR_S = 0.25


class EngineWorker:
    """Wrap a DecodeEngine as a transport-served, store-coordinated
    serving worker. ``overrides`` build its ``EngineConfig``; ``mesh=``
    among them shards the engine over an mp group, as the reference's
    (every rank of the group must make the same engine calls: the CLI's
    :class:`LockstepEngine`)."""

    def __init__(self, model, store, config: Optional[EngineConfig] = None,
                 *, name: Optional[str] = None,
                 namespace: str = DEFAULT_NAMESPACE,
                 step_floor_s: float = 0.0, role: str = "unified",
                 kv_wire: str = "raw", device=None, **overrides):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if kv_wire not in ("raw", "int8"):
            raise ValueError(f"kv_wire must be raw|int8, got {kv_wire!r}")
        self.engine = DecodeEngine(model, config, device=device,
                                   **overrides)
        self._store = store
        self._ns = namespace
        self._step_floor_s = float(step_floor_s)
        self.role = role
        self._kv_wire = kv_wire
        self._server = TransportServer()
        with deadline_guard("register engine"):
            self.index = int(self._store.add(k_count(namespace), 1)) - 1
        self.name = name or f"engine{self.index}"
        cfg = self.engine.config
        record = {
            "name": self.name,
            "index": self.index,
            "num_slots": cfg.num_slots,
            "max_length": cfg.max_length,
            "page_size": cfg.page_size,
            "buckets": list(self.engine.buckets),
            "pid": os.getpid(),
            "addr": self._server.addr,
            "role": role,
            "kv_wire": kv_wire,
        }
        with deadline_guard("register engine"):
            self._store.set(k_engine(namespace, self.index), pack(record))
        #: per-channel seq state: the dispatch stream is one channel of a
        #: shared connection (tensor-queue frames number independently)
        self._rx_seq = SeqChannels()
        self._beat = 0
        #: live-telemetry shipper, created lazily on the first beat with
        #: the plane enabled and a router attached
        self._live_shipper: Optional[_live.LiveShipper] = None
        self._local_rid: Dict[int, int] = {}  # engine rid -> router rid
        self._last_occ_pub = 0.0
        self._last_occ_store = -float("inf")
        self._last_drain = -float("inf")
        self._last_store_drain = -float("inf")
        self._done_count = 0  # lifetime results published (rides the beat)
        #: connection ids that sent a router hello (done/occ frames go here)
        self._router_cids: set = set()
        #: prefill role: dispatch records awaiting export + KV handoff
        self._prefill_jobs: deque = deque()
        #: decode/unified role: kv frames awaiting a free slot
        self._kv_imports: deque = deque()
        #: prefill role: persistent links to decode workers, by address
        self._kv_links: Dict[str, TransportClient] = {}
        #: fleet-supervisor drain order (per-engine ctl key): while True
        #: the worker admits NO new dispatches but keeps stepping the
        #: engine so in-flight requests finish; once idle its beat
        #: advertises ``drained`` and the supervisor can flip its role
        self.draining = False
        self._idle = True
        self._last_drain_ctl = -float("inf")
        #: connection ids with a live wt (weight-epoch) stream attached
        self._wt_cids: set = set()
        self.publish_occupancy()

    # -- transport I/O ------------------------------------------------------

    def _pump_transport(self):
        """Drain every transport connection: stash dispatch records by
        seq (the consume loop enforces order and skips duplicates from
        retransmits), queue KV-page streams, learn which connections are
        routers."""
        for cid, frame in self._server.poll():
            t = frame.get("t")
            if t == "hello":
                if frame.get("peer") == "router":
                    self._router_cids.add(cid)
            elif t == "dispatch":
                # only routers dispatch: treat the conn as one even if
                # its hello frame was lost (chaos half_open)
                self._router_cids.add(cid)
                for rec in frame.get("reqs", ()):
                    self._rx_seq.stash("dispatch", int(rec["seq"]), rec)
            elif t == "kv":
                self._kv_imports.append(frame)
            elif t == "wt":
                # weight-epoch stream (serving/online.py). Seqs are per
                # publisher connection: a restarted coordinator redials
                # and restarts at 0, so the channel is keyed by cid
                self._rx_seq.stash(f"wt:{cid}", int(frame["seq"]),
                                   (cid, frame))
                self._wt_cids.add(cid)
        live = set(self._server.conn_ids())
        self._router_cids &= live

    #: wt frames applied per poll round: a whole epoch's leaves can land
    #: in one socket batch, and applying them all before the next engine
    #: step would stall in-flight decode, the drain the flip exists to
    #: avoid
    _WT_FRAMES_PER_POLL = 2

    def _drain_weights(self):
        """Apply stashed wt frames in seq order between engine steps
        (``online.apply_wt_frame`` is the only promote / discard call
        site) and ack each to its publisher. Runs while draining too: a
        weight flip is not an admission. The budget goes round-robin, one
        frame a publisher connection a pass."""
        from .online import apply_wt_frame

        budget = self._WT_FRAMES_PER_POLL
        cids = sorted(self._wt_cids)
        while budget > 0:
            progressed = False
            for cid in cids:
                if budget <= 0:
                    break
                item = self._rx_seq.pop_next(f"wt:{cid}")
                if item is None:
                    continue
                _cid, frame = item
                self._server.send(cid, apply_wt_frame(self.engine, frame))
                budget -= 1
                progressed = True
            if not progressed:
                break
        # a dead publisher's channel is dropped whole: its stashed frames
        # can never be consumed, and a reconnect comes under a new cid
        live = set(self._server.conn_ids())
        for cid in self._wt_cids - live:
            self._rx_seq.drop(f"wt:{cid}")
        self._wt_cids &= live

    def _send_routers(self, frame: dict):
        for cid in list(self._router_cids):
            self._server.send(cid, frame)

    # -- request intake -----------------------------------------------------

    def _drain_requests(self):
        """Consume this engine's request stream in seq order. Wire-stashed
        records are consumed first (no store round trip); the store key
        for the same seq is only checked at the slow mirror cadence once
        a router socket is attached — it is the fallback path for frames
        lost to a socket failure, and the ONLY path on the legacy store
        dataplane (no router connection)."""
        while True:
            rec = self._rx_seq.pop_next("dispatch")
            src = "wire"
            if rec is None:
                now = time.monotonic()
                if (self._router_cids
                        and now - self._last_store_drain < _STORE_MIRROR_S):
                    return
                key = k_req(self._ns, self.name,
                            self._rx_seq.cursor("dispatch"))
                with deadline_guard("recv request"):
                    if not self._store.check(key):
                        self._last_store_drain = now
                        return
                    rec = unpack(self._store.get(key))
                src = "store"
                self._rx_seq.advance("dispatch")
            self._consume(rec, src)

    def _consume(self, rec: dict, src: str):
        """One dispatch record into the engine (unified/decode) or the
        prefill job queue (prefill role)."""
        rid = rec["rid"]
        tr = rec.get("trace")
        dh = None
        if tr:
            # continue the router's trace: the transit span is wall-to-
            # wall against the router's dispatch_ts (host clock skew
            # shifts it; every other duration is monotonic)
            retry = int(tr.get("resubmits", 0) or 0) > 0
            if src == "wire":
                _obs.record_span(
                    "srv_net_transit", trace_id=tr["trace_id"],
                    parent_id=tr["parent_id"],
                    start_ts=tr.get("dispatch_ts"), rid=rid,
                    engine=self.name, retry=retry)
            else:
                _obs.record_span(
                    "srv_store_transit", trace_id=tr["trace_id"],
                    parent_id=tr["parent_id"],
                    start_ts=tr.get("dispatch_ts"), rid=rid,
                    engine=self.name, retry=retry)
            dh = _obs.start_span(
                "srv_drain", trace_id=tr["trace_id"],
                parent_id=tr["parent_id"], rid=rid, engine=self.name)
        if self.role == "prefill":
            self._prefill_jobs.append({"rec": rec, "frame": None})
            if dh:
                _obs.end_span(dh, queued="prefill")
            return
        try:
            local = self.engine.submit(
                np.asarray(rec["prompt"], np.int64),
                SamplingParams(**rec["params"]), trace=tr,
                tenant=rec.get("tenant"), slo=rec.get("slo"))
        except ValueError as e:
            # invalid geometry for THIS engine (bucket/page limits):
            # report instead of dying — the router surfaces the error
            if dh:
                _obs.end_span(dh, error=str(e))
            self._publish_one_done(
                {"rid": rid, "engine": self.name, "error": str(e)})
            return
        if dh:
            _obs.end_span(dh)
        self._local_rid[local] = rid

    # -- disaggregated prefill ----------------------------------------------

    def _advance_prefill(self):
        """Prefill role: run the head job's prefill and stream its KV
        pages to the target decode worker. A job whose export cannot get
        a slot/pages stays at the head and is retried next poll; a job
        whose KV send failed rotates to the BACK so one unreachable
        decode peer cannot head-of-line-block handoffs to the others
        (the built frame is cached, so a resend never re-runs the
        prefill)."""
        for _ in range(len(self._prefill_jobs)):
            job = self._prefill_jobs[0]
            rec = job["rec"]
            rid = rec["rid"]
            if job["frame"] is None:
                tr = rec.get("trace")
                try:
                    payload = self.engine.prefill_export(
                        np.asarray(rec["prompt"], np.int64),
                        SamplingParams(**rec["params"]), trace=tr,
                        tenant=rec.get("tenant"), slo=rec.get("slo"))
                except ValueError as e:
                    self._publish_one_done(
                        {"rid": rid, "engine": self.name, "error": str(e)})
                    self._prefill_jobs.popleft()
                    continue
                if payload is None:
                    return  # no slot/pages yet; retry next poll
                if "done" in payload:
                    # finished at prefill (1-token budget / instant EOS)
                    self._publish_one_done(
                        {"rid": rid, "engine": self.name,
                         "tokens": np.asarray(payload["done"]).tolist()})
                    self._prefill_jobs.popleft()
                    continue
                job["frame"] = {
                    "t": "kv", "rid": rid, "rec": rec,
                    "first_token": payload["first_token"],
                    "true_len": payload["true_len"],
                    "prefill_s": payload["prefill_s"],
                    "kv": encode_kv(payload["k"], payload["v"],
                                    self._kv_wire, payload.get("ks"),
                                    payload.get("vs"),
                                    dtype=payload["dtype"]),
                    "ts": time.time(),
                }
            link = self._kv_link(rec["kv_to"]["addr"])
            if not link.send(job["frame"]):
                # decode peer unreachable; rotate and let backoff govern
                # the redial while other targets make progress
                self._prefill_jobs.rotate(-1)
                continue
            self._prefill_jobs.popleft()
            # tell the router the handoff happened, so it can retire this
            # rid from the prefill stream's load accounting
            self._send_routers({"t": "relay", "rids": [rid]})

    def _kv_link(self, addr: str) -> TransportClient:
        link = self._kv_links.get(addr)
        if link is None:
            link = TransportClient(addr, seed=self.index)
            self._kv_links[addr] = link
        return link

    def _advance_kv_imports(self):
        """Decode/unified role: adopt streamed prefills as free slots
        allow. Import order is arrival order; a head frame waiting for a
        slot blocks the rest (they need slots too)."""
        while self._kv_imports:
            frame = self._kv_imports[0]
            rec = frame["rec"]
            rid = rec["rid"]
            tr = rec.get("trace")
            kv = frame.get("_decoded")
            if kv is None:
                got = decode_kv(frame["kv"])
                kv = {"first_token": frame["first_token"],
                      "true_len": frame["true_len"],
                      "prefill_s": frame.get("prefill_s", 0.0),
                      "k": got["k"], "v": got["v"], "dtype": got["dtype"]}
                if "k_scale" in got:  # int8 POOL slabs travel raw
                    kv["ks"] = got["k_scale"]
                    kv["vs"] = got["v_scale"]
                frame["_decoded"] = kv
            try:
                local = self.engine.try_import_prefill(
                    np.asarray(rec["prompt"], np.int64),
                    SamplingParams(**rec["params"]), kv, trace=tr,
                    tenant=rec.get("tenant"), slo=rec.get("slo"))
            except ValueError as e:
                self._publish_one_done(
                    {"rid": rid, "engine": self.name, "error": str(e)})
                self._kv_imports.popleft()
                continue
            if local is None:
                return  # no slot/pages yet; retry next poll
            if tr:
                # wall-to-wall KV stream span: export-side send stamp to
                # import completion, the disaggregated analogue of the
                # transit spans
                _obs.record_span(
                    "srv_kv_stream", trace_id=tr["trace_id"],
                    parent_id=tr["parent_id"], start_ts=frame.get("ts"),
                    rid=rid, engine=self.name,
                    wire=frame["kv"].get("wire"),
                    pages=int(np.asarray(frame["kv"]["k"]).shape[1]))
            self._local_rid[local] = rid
            self._kv_imports.popleft()

    # -- results + occupancy ------------------------------------------------

    def _publish_one_done(self, rec: dict):
        """STORE first (harvest ground truth), wire echo second — the
        done-before-ack invariant rides the store write order."""
        with deadline_guard("publish result"):
            self._store.set(k_done(self._ns, rec["rid"]), pack(rec))
        self._done_count += 1
        self._send_routers({"t": "done", "recs": [rec]})

    def _publish_done(self) -> int:
        """Write finished token streams; returns how many. Runs BEFORE
        publish_occupancy in poll_once so a completed request is always
        harvestable once its seq is acked — the failover no-loss/no-dup
        invariant. The wire echo (one batched frame) happens after every
        store write, so a router acting on the frame can already trust
        the store."""
        recs = []
        for local, rid in list(self._local_rid.items()):
            if self.engine._requests[local].status != "done":
                continue
            tokens = self.engine.result(local)
            rec = {"rid": rid, "engine": self.name,
                   "tokens": np.asarray(tokens).tolist()}
            with deadline_guard("publish result"):
                self._store.set(k_done(self._ns, rid), pack(rec))
            del self._local_rid[local]
            self._done_count += 1
            recs.append(rec)
        if recs:
            self._send_routers({"t": "done", "recs": recs})
        return len(recs)

    def publish_occupancy(self, force_store: bool = False):
        """Occupancy beat: engine load snapshot + monotone ``beat`` (the
        router's liveness signal) + ``acked_seq`` (requests consumed, so
        the router can estimate load it dispatched but the engine hasn't
        reported yet). The beat rides the router socket as the heartbeat;
        the store copy — the failover ground truth — is mirrored at a
        slow cadence (every write follows the done keys it acks)."""
        self._beat += 1
        now = time.monotonic()
        self._last_occ_pub = now
        occ = self.engine.occupancy()
        occ["beat"] = self._beat
        occ["acked_seq"] = self._rx_seq.cursor("dispatch")
        occ["done_count"] = self._done_count
        occ["name"] = self.name
        occ["role"] = self.role
        occ["prefill_queue"] = len(self._prefill_jobs)
        occ["draining"] = self.draining
        occ["drained"] = self.draining and self._idle
        self._send_routers({"t": "occ", "occ": occ, "ts": time.time()})
        # live-telemetry piggyback: the tele batch rides the SAME links at
        # the SAME cadence — no extra socket, no extra thread. Only collect
        # once a router is attached, so the span tail is not consumed
        # before anyone can receive it (the ring only re-sends ~3 beats).
        if self._router_cids and _live.live_enabled():
            if self._live_shipper is None:
                self._live_shipper = _live.LiveShipper(
                    self.name,
                    ledger_fn=self.engine.accounting_ledger)
            pays = self._live_shipper.collect()
            if pays:
                self._send_routers({"t": "tele", "pays": pays})
        if (force_store or not self._router_cids
                or now - self._last_occ_store >= _STORE_MIRROR_S):
            self._last_occ_store = now
            with deadline_guard("publish occupancy"):
                self._store.set(k_occ(self._ns, self.name), pack(occ))

    def stop_requested(self) -> bool:
        ctl = k_ctl(self._ns)
        with deadline_guard("poll ctl"):
            if not self._store.check(ctl):
                return False
            rec = unpack(self._store.get(ctl))
        return bool(rec.get("stop"))

    def _check_drain_ctl(self):
        """Adopt the fleet supervisor's drain/resume order for this
        engine (per-engine ctl key), at the slow store-mirror cadence —
        it is control plane, not request path. A beat is forced on every
        EDGE so the router and the supervisor see the new ``draining``/
        ``drained`` state within one mirror period."""
        now = time.monotonic()
        if now - self._last_drain_ctl < _STORE_MIRROR_S:
            return
        self._last_drain_ctl = now
        key = k_ctl_engine(self._ns, self.name)
        with deadline_guard("poll drain ctl"):
            if not self._store.check(key):
                return
            rec = unpack(self._store.get(key))
        want = bool(rec.get("drain"))
        if want != self.draining:
            self.draining = want
            self.publish_occupancy(force_store=True)

    # -- scheduler ----------------------------------------------------------

    def poll_once(self) -> bool:
        """One deterministic worker round: pump the transport, drain new
        requests, advance the engine one step (chaos fence first —
        PADDLE_CHAOS_ENGINE_* can SIGKILL here, mid-decode), publish
        results + occupancy. The occupancy beat is throttled to ~40 Hz on
        the wire (its store mirror far slower): the router samples it far
        slower still, and unthrottled publishes just contend the fabric.
        The request drain check is likewise throttled to ~50 Hz while the
        engine is busy — its internal queue keeps the slots fed between
        checks; an idle engine checks every poll so first dispatch lands
        fast. Returns True while the engine still holds work."""
        self._pump_transport()
        if self._wt_cids:
            self._drain_weights()
        self._check_drain_ctl()
        now = time.monotonic()
        if self.draining:
            # drain order in effect: admit nothing new — undispatched
            # seqs stay unconsumed for the router's evacuate/handoff;
            # in-flight work below still runs to completion
            pass
        elif not self._local_rid or now - self._last_drain >= 0.02:
            self._last_drain = now
            self._drain_requests()
        if self.role == "prefill":
            self._advance_prefill()
        if self._kv_imports:
            self._advance_kv_imports()
        chaos.engine_fence(self.engine.decode_steps)
        t_step = time.monotonic()
        busy = self.engine.step()
        if busy and self._step_floor_s > 0.0:
            # step floor: pace the scheduler as if each step took at least
            # this long on the device (host idle meanwhile), so a host-only
            # worker can stand in for a card in a control-plane benchmark;
            # also a crude per-engine rate limit
            rem = self._step_floor_s - (time.monotonic() - t_step)
            if rem > 0.0:
                time.sleep(rem)
        published = self._publish_done()
        working = (busy or bool(self._local_rid)
                   or bool(self._prefill_jobs) or bool(self._kv_imports))
        self._idle = not working
        if published or time.monotonic() - self._last_occ_pub >= 0.025:
            self.publish_occupancy(force_store=bool(published))
        return working

    def serve(self, poll_interval: float = 0.005,
              ctl_interval: float = 0.25,
              report: Optional[Callable[[str], None]] = None):
        """Poll until the router broadcasts stop. Idle rounds sleep
        ``poll_interval``; the stop broadcast is only polled every
        ``ctl_interval`` seconds — it is the cold path. ``report``, when
        given, is called with ``"first_done"`` once the worker has
        published its first result and with ``"stop"`` at the stop
        broadcast (the CLI prints its status record there)."""
        last_ctl = -float("inf")
        first = report is not None
        try:
            while True:
                now = time.monotonic()
                if now - last_ctl >= ctl_interval:
                    last_ctl = now
                    if self.stop_requested():
                        if report is not None:
                            report("stop")
                        return
                if not self.poll_once():
                    time.sleep(poll_interval)
                if first and self._done_count:
                    first = False
                    report("first_done")
        finally:
            self.close()

    def close(self):
        """Close the listener and the KV links (``serve`` does on return;
        callers that drive ``poll_once`` themselves call it)."""
        self._server.close()
        for link in self._kv_links.values():
            link.close()


def build_worker_model(args):
    """Deterministic GPT build shared by every worker process AND the
    in-process reference engines of the tests and ``chip_smoke.py``: same
    seed => same weights => bit-equal token streams across processes."""
    from ..text.models.gpt import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_hidden_layers=args.layers, num_attention_heads=args.heads,
        max_position_embeddings=args.max_positions,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        device=args.device, seed=args.model_seed)
    model.eval()
    if getattr(args, "amp_dtype", "float32") != "float32":
        from .. import amp

        amp.decorate(model, level="O2", dtype=args.amp_dtype)
    return model


def build_arg_parser():
    import argparse

    p = argparse.ArgumentParser("paddle_tpu_torch.serving.worker")
    p.add_argument("--master", default=os.environ.get(
        "PADDLE_SERVING_MASTER", "127.0.0.1:29500"),
        help="host:port of the coordination store (PADDLE_SERVING_MASTER)")
    p.add_argument("--namespace", default=DEFAULT_NAMESPACE)
    p.add_argument("--name", default=None)
    p.add_argument("--role", default="unified", choices=list(ROLES),
                   help="unified = prefill+decode per request; prefill = "
                        "export KV pages and stream them to decode "
                        "workers; decode = import streamed prefills")
    p.add_argument("--kv-wire", default="raw", choices=["raw", "int8"],
                   help="KV-page stream codec: raw is bit-equal, int8 "
                        "absmax-quantizes per [layer, page, head] "
                        "(~4x smaller frames for f32 pages, ~2x for bf16)")
    p.add_argument("--poll-interval", type=float, default=0.005)
    p.add_argument("--step-floor-ms", type=float, default=0.0,
                   help="minimum wall time per scheduler step; emulates "
                        "device-bound steps on host-only workers and "
                        "doubles as a crude rate limiter")
    p.add_argument("--warmup", action="store_true",
                   help="run every engine program once before serving — "
                        "each prefill bucket, the single-token decode, and "
                        "the verify step when --speculate-k > 0")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) "
                        "or cpu")
    # model spec (must match the router / reference build)
    p.add_argument("--model-seed", type=int, default=7)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--max-positions", type=int, default=512)
    p.add_argument("--amp-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 serves the model decorated O2 "
                        "(amp.decorate): bf16 parameters and activations")
    # engine geometry
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-length", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--speculate-k", type=int, default=0)
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--kv-dtype", default="f32")
    p.add_argument("--mp", type=int, default=1,
                   help="shard decode over this many ranks' mp axis (dp1 x "
                        "mp mesh; the follower ranks run on the same "
                        "device, over gloo)")
    return p


#: the engine's counts a worker's (and a follower's) status record carries
_ENGINE_FIELDS = ("prefill_calls", "decode_steps", "verify_steps",
                  "total_tokens", "prefix_hit_tokens", "weight_epoch")


def _status_record(worker: "EngineWorker", event: str) -> dict:
    """What the CLI prints on stderr after its first result and at the
    stop broadcast: its device, the K3 launches (by regime) its engine
    made in this process so far, its float32 matmul settings."""
    import torch

    from ..ops import paged_attention as pa

    dev = worker.engine.device
    return {"event": event, "worker": worker.name, "role": worker.role,
            "pid": os.getpid(),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "device_type": dev.type,
            "k3": {n: getattr(pa, n) for n in (
                "launches", "launches_tile", "launches_split",
                "launches_decode", "launches_verify")},
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision(),
            "engine": {k: worker.engine.stats()[k] for k in _ENGINE_FIELDS}}


#: the engine calls that change its state: rank 0 of an mp worker hands
#: each to the followers before it makes it
_LOCKSTEP_CALLS = ("submit", "prefill_export", "try_import_prefill", "step",
                   "warmup", "begin_weight_epoch", "stage_weight",
                   "promote_epoch", "discard_shadow")
#: the environment variable that makes a worker process a follower rank
_MP_RANK_ENV = "PADDLE_SERVING_MP_RANK"


class FollowerLost(RuntimeError):
    """A follower rank of an mp worker exited or stopped reading."""


class LockstepEngine:
    """Rank 0's view of an mp engine: the ``DecodeEngine`` itself for every
    read, and for each call of ``_LOCKSTEP_CALLS`` the call pickled to
    every follower first (they make the same call on their engines, whose
    collectives meet rank 0's). Raises :class:`FollowerLost` when a
    follower has exited or its pipe is closed."""

    def __init__(self, engine, followers):
        self._engine = engine
        self._followers = list(followers)

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name not in _LOCKSTEP_CALLS:
            return attr

        def call(*args, **kwargs):
            self.check_followers()
            if name == "step" and not (self._engine._running
                                       or self._engine._waiting):
                return attr()   # idle: no program runs on any rank
            self.send((name, args, kwargs))
            return attr(*args, **kwargs)

        return call

    def check_followers(self):
        for p in self._followers:
            if p.poll() is not None:
                raise FollowerLost(f"mp follower pid {p.pid} exited with "
                                   f"code {p.returncode}")

    def send(self, msg):
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        for p in self._followers:
            try:
                p.stdin.write(data)
                p.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                raise FollowerLost(f"mp follower pid {p.pid}: {e}") from e

    def stop(self, timeout: float = 60.0):
        """Tell the followers to stop and wait for them; kill any left."""
        try:
            self.send(("stop", (), {}))
        except FollowerLost:
            pass
        _reap(self._followers, timeout)


def _reap(procs, timeout):
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _engine_overrides(args) -> dict:
    return dict(num_slots=args.slots, max_length=args.max_length,
                page_size=args.page_size, speculate_k=args.speculate_k,
                prefix_cache=not args.no_prefix_cache,
                kv_dtype=args.kv_dtype)


def _mp_setup(args, rank: int, rendezvous: str):
    """Join the gloo group of the worker's ``args.mp`` ranks and return
    the ``dp 1 x mp`` mesh the engine shards over."""
    import numpy as _np

    from ..device import set_device
    from ..distributed import ProcessMesh
    from ..distributed.env import init_parallel_env

    set_device(args.device)
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(args.mp),
                       "PADDLE_MASTER": rendezvous,
                       "PADDLE_DISTRI_BACKEND": "gloo"})
    init_parallel_env("gloo")
    return ProcessMesh(_np.arange(args.mp).reshape(1, args.mp),
                       dim_names=["dp", "mp"])


def _follower_main(args, rank: int) -> int:
    """A follower rank: build the same model and engine, then make every
    call rank 0 pickles on stdin until ``stop`` (exit 0) or the end of
    stdin (rank 0 is gone: exit 1)."""
    import json

    from ..ops import paged_attention as pa

    mesh = _mp_setup(args, rank, os.environ["PADDLE_MASTER"])
    model = build_worker_model(args)
    engine = DecodeEngine(model, device=args.device, mesh=mesh,
                          **_engine_overrides(args))
    stdin = sys.stdin.buffer
    while True:
        try:
            name, a, kw = pickle.load(stdin)
        except EOFError:
            return 1
        if name == "stop":
            break
        try:
            getattr(engine, name)(*a, **kw)
        except ValueError:
            pass   # a bad request: rank 0 meets the same error and reports
    print(json.dumps({"serving_worker_follower": {
        "rank": rank, "pid": os.getpid(),
        "k3": {n: getattr(pa, n) for n in (
            "launches", "launches_tile", "launches_split",
            "launches_decode", "launches_verify")},
        "engine": {k: engine.stats()[k] for k in _ENGINE_FIELDS}}}),
        file=sys.stderr, flush=True)
    return 0


def _start_followers(args, argv, rendezvous):
    procs = []
    for r in range(1, args.mp):
        env = dict(os.environ, **{_MP_RANK_ENV: str(r),
                                  "PADDLE_MASTER": rendezvous})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
             *argv], env=env, stdin=subprocess.PIPE))
    return procs


def main(argv=None):
    import shutil
    import tempfile

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_arg_parser().parse_args(argv)
    if os.environ.get(_MP_RANK_ENV):
        return _follower_main(args, int(os.environ[_MP_RANK_ENV]))
    if args.mp <= 1:
        return _serve(args, None, None)
    tmp = tempfile.mkdtemp(prefix="paddle_serving_mp_")
    rendezvous = "file://" + os.path.join(tmp, "rendezvous")
    followers = _start_followers(args, argv, rendezvous)
    try:
        mesh = _mp_setup(args, 0, rendezvous)
        return _serve(args, mesh, followers)
    finally:
        for p in followers:
            if p.poll() is None:
                p.kill()
        _reap(followers, 10.0)
        shutil.rmtree(tmp, ignore_errors=True)


def _serve(args, mesh, followers):
    """Rank 0 (or the only rank): register one engine and serve."""
    import json

    from ..runtime import TCPStore

    model = build_worker_model(args)
    host, port = args.master.rsplit(":", 1)
    store = TCPStore(host=host, port=int(port), is_master=False, timeout=60.0)
    worker = EngineWorker(
        model, store, name=args.name, namespace=args.namespace,
        step_floor_s=args.step_floor_ms / 1000.0, role=args.role,
        kv_wire=args.kv_wire, device=args.device,
        mesh=mesh, **_engine_overrides(args))
    lockstep = None
    if followers:
        lockstep = worker.engine = LockstepEngine(worker.engine, followers)
    if args.warmup:
        w = worker.engine.warmup()
        print(f"[serving] worker {worker.name} warm "
              f"({w['buckets']} buckets + decode"
              + (" + verify" if w["verify"] else "") + ")",
              file=sys.stderr, flush=True)
    print(f"[serving] worker {worker.name} (engine {worker.index}, "
          f"{worker.role}, {worker.engine.device}, mp {args.mp}, "
          f"followers {[p.pid for p in followers or ()]}) serving via "
          f"{args.master} + {worker._server.addr}",
          file=sys.stderr, flush=True)

    def report(event):
        rec = _status_record(worker, event)
        rec["mp"] = args.mp
        rec["followers"] = [p.pid for p in followers or ()]
        print(json.dumps({"serving_worker": rec}), file=sys.stderr,
              flush=True)

    worker.serve(poll_interval=args.poll_interval, report=report)
    if lockstep is not None:
        lockstep.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
