"""Online weight epochs: zero-drain versioned weight flips (counterpart of
``paddle_tpu/serving/online.py``).

A trainer publishes weight epoch ``E+1`` into live decode engines while
they keep serving epoch ``E``: each engine stages the new values into a
shadow set (``engine.begin_weight_epoch`` / ``stage_weight``), then swaps
them in at a request boundary (``promote_epoch``). In-flight requests
finish on the epoch they started (the engine pins their values), new
admissions take ``E+1``, and greedy decode stays bit-equal per (seed,
epoch).

Weights travel as seq-acked ``wt`` frames (``transport.encode_wt_frame``,
bf16 wire by default; a bf16 leaf goes raw, as its bf16 words) over the
same persistent transport as the request dataplane: in process through
:class:`EngineSink`, over a socket through :class:`WireEngineSink` (the
worker applies frames between engine steps). Only changed leaves go on
the wire: the coordinator keeps a digest of the last payload each engine
acked per leaf and skips bit-equal ones, so a fine-tune that touches two
layers streams two layers. A leaf may be a tensor or a host array.

Every flip is a journaled two-phase transaction in the fleet supervisor's
:class:`~paddle_tpu_torch.distributed.fleet.supervisor.FlipJournal`
(``weights_current.json``), with ``chaos.weight_fence`` fault points at
each fence so soaks can SIGKILL the publisher mid-stream:

    publish -> stream -> [leaf sends, fence ``wt:<seq>``] -> commit
            -> swap -> finalize -> close(committed)

A crash before ``commit`` rolls back (``recover`` discards engine shadows
and retires the doc); a crash at or past ``commit`` rolls forward:
``recover`` retires the doc and the deterministic trainer's idempotent
convergence loop (:meth:`OnlineCoordinator.ensure_epoch`) re-publishes the
epoch; the engines' ``epoch <= live`` no-op guards make the flip
exactly-once however often the stream is replayed, and ``close_weights``
keeps one committed entry per epoch.

Only :func:`apply_wt_frame` calls ``promote_epoch`` / ``discard_shadow``
(``tests/test_torch_online.py`` holds it with a scan of the package).

End to end, decode engines double as rollout workers::

    out = rollout_round(coord, epoch, generate_fn=sample_prompts,
                        reward_fn=score, train_fn=sgd_steps)

This module is the single writer of the ``online_*`` metric family and
the ``weight_flip`` span.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import observability as _obs
from ..distributed import reshard as _reshard
from ..framework.dtype import from_host
from ..testing import chaos
from .protocol import deadline_guard
from .transport import (TransportClient, decode_wt_frame, encode_wt_ack,
                        encode_wt_frame)

__all__ = ["WEIGHT_CHANNEL", "apply_wt_frame", "EngineSink",
           "WireEngineSink", "OnlineCoordinator", "rollout_round"]

#: the wt stream's SeqChannels channel name (per coordinator connection)
WEIGHT_CHANNEL = "wt"


def apply_wt_frame(engine, frame: dict) -> dict:
    """Apply one decoded ``wt`` frame to a live engine and build its ack.

    This is the only call site of ``engine.promote_epoch`` /
    ``engine.discard_shadow`` in the package: every swap an engine ever
    performs traces back to a journaled weight transaction that built the
    frame. Exactly-once falls
    out of the engine's no-op guards — a replayed ``begin`` for a
    committed epoch returns applied=False and the following ``leaf``
    frames are dropped on the floor (no open shadow), a replayed ``swap``
    acks applied=False.
    """
    kind, epoch, name, arr, _meta = decode_wt_frame(frame)
    if arr is not None:  # a bf16 leaf arrives as its bf16 words
        arr = from_host(arr, frame["x"]["dtype"])
    applied: Optional[bool] = None
    if kind == "begin":
        applied = engine.begin_weight_epoch(epoch)
    elif kind == "leaf":
        if (engine._shadow is not None
                and engine._shadow["epoch"] == int(epoch)):
            engine.stage_weight(name, arr)
            applied = True
        else:
            applied = False  # replay onto a committed epoch: drop
    elif kind == "swap":
        applied = engine.promote_epoch(epoch)
    elif kind == "discard":
        applied = engine.discard_shadow(epoch)
    # the ack echoes the frame kind and the engine's post-apply serving
    # epoch: ``live`` is the only field that proves what the engine
    # serves — a begin/leaf/discard ack carries the pre-flip epoch
    # there, so the publisher can never mistake "shadow opened" for
    # "epoch flipped" (encode_wt_ack documents per-kind semantics)
    return encode_wt_ack(frame["ch"], frame["seq"], epoch, applied=applied,
                         kind=kind, live=int(engine.weight_epoch))


class EngineSink:
    """In-process sink: frames apply synchronously to a local engine.

    Used by the colocated trainer path (train and serve in one process)
    and by the bench/offline-parity harnesses — the same frames, the same
    :func:`apply_wt_frame` chokepoint, zero sockets.
    """

    def __init__(self, engine, name: str = "engine0"):
        self.engine = engine
        self.name = name
        #: highest epoch this sink is known to serve (ack-derived)
        self.known_epoch = int(engine.weight_epoch)
        self._acks: List[dict] = []

    def send(self, frame: dict) -> bool:
        ack = apply_wt_frame(self.engine, frame)
        self._acks.append(ack)
        return True

    def pump(self) -> None:  # wire parity: nothing to poll
        pass

    def collect_acks(self) -> List[dict]:
        out, self._acks = self._acks, []
        return out

    def close(self) -> None:
        pass


class WireEngineSink:
    """Socket sink: frames ride a persistent :class:`TransportClient` to
    an :class:`~paddle_tpu_torch.serving.worker.EngineWorker`, which applies
    them between engine steps and acks per seq. ``pump`` drains acks;
    the coordinator blocks on them under a deadline guard."""

    def __init__(self, addr: str, name: str):
        self.client = TransportClient(addr)
        self.name = name
        self.known_epoch = -1
        self._acks: List[dict] = []

    def send(self, frame: dict) -> bool:
        return self.client.send(frame)

    def pump(self) -> None:
        for fr in self.client.poll():
            if fr.get("t") == "wt_ack":
                self._acks.append(fr)

    def collect_acks(self) -> List[dict]:
        self.pump()
        out, self._acks = self._acks, []
        return out

    def close(self) -> None:
        self.client.close()


class OnlineCoordinator:
    """Trainer-side publisher of versioned weight epochs into a fleet of
    live engines.

    One instance owns the journal's weight transaction, the per-engine
    wt seq streams, and the per-engine last-sent digests that turn a full
    param set into a delta set. ``sinks`` maps engine name to an
    :class:`EngineSink` or :class:`WireEngineSink`.

    Size ``ack_timeout_s`` to the model: a worker applies at most
    ``EngineWorker._WT_FRAMES_PER_POLL`` wt frames per poll round (so
    decode never stalls), so a full-delta stream needs about
    ``leaves / _WT_FRAMES_PER_POLL`` rounds — for many-leaf models
    raise the timeout above the 30s default accordingly.
    """

    def __init__(self, journal, sinks: Dict[str, object], *,
                 wire: str = "bf16", ack_timeout_s: float = 30.0,
                 yield_fn=None):
        self.journal = journal
        self.sinks = dict(sinks)
        self.wire = wire
        self.ack_timeout_s = float(ack_timeout_s)
        #: cooperative-yield hook for SINGLE-PROCESS embeddings (benches,
        #: tests) where the publisher and an in-process engine share one
        #: thread: called between leaf encodes so the engine keeps
        #: stepping while the delta set is prepared. The wire topology
        #: gets this for free — encode runs on the trainer host.
        self._yield_fn = yield_fn
        #: per engine: leaf name -> sha1 of the last payload it acked
        self._digests: Dict[str, Dict[str, str]] = {
            name: {} for name in self.sinks}
        #: per engine: next wt seq on its stream
        self._seq: Dict[str, int] = {name: 0 for name in self.sinks}
        #: global frame counter driving the ``wt:<n>`` chaos fences
        self._frames_sent = 0

    # -- delta computation --------------------------------------------------

    def _encode_leaves(self, params: Dict[str, object],
                       layouts: Optional[dict] = None,
                       src_mesh=None, dst_mesh=None, dst_spec=None):
        """Encode every leaf once (the wire payload is shared across
        engines) and fingerprint it. When the trainer hands over its
        recorded layouts, each leaf carries the reshard read-spec
        (``plan_restore_spec``) re-expressing the TRAINING mesh's shard
        granularity onto the serving mesh — the engine replicates either
        way, but the spec bounds what each serving host reads."""
        leaves = []
        for name in sorted(params):
            if self._yield_fn is not None:
                self._yield_fn()
            arr = params[name]
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            meta = None
            if layouts and name in layouts and dst_mesh is not None:
                rec = layouts[name]
                spec = _reshard.plan_restore_spec(
                    rec, src_mesh, dst_mesh,
                    dst_spec if dst_spec is not None
                    else rec.pspec())
                meta = {"spec": [list(p) for p in
                                 _reshard._norm_spec(spec, arr.ndim)]}
            payload = encode_wt_frame("?", 0, "leaf", 0, name=name,
                                      arr=arr, wire=self.wire)["x"]
            h = hashlib.sha1(np.ascontiguousarray(payload["x"]).tobytes())
            if "scale" in payload:
                h.update(np.ascontiguousarray(payload["scale"]).tobytes())
            nbytes = (arr.numel() * arr.element_size()
                      if isinstance(arr, torch.Tensor) else arr.nbytes)
            leaves.append((name, payload, meta, h.hexdigest(), int(nbytes)))
        return leaves

    def _send(self, sink, frame: dict) -> None:
        self._frames_sent += 1
        chaos.weight_fence(f"wt:{self._frames_sent}")
        sink.send(frame)

    def _wait_acks(self, want: Dict[str, set], doc: dict) -> None:
        """Block until every engine acked every listed seq (its worker
        applies frames between steps, so this bounds the stream, not the
        flip — decode continues throughout)."""
        with deadline_guard("wt stream acks", self.ack_timeout_s):
            deadline = time.monotonic() + self.ack_timeout_s
            while any(want.values()):
                for name, pending in want.items():
                    if not pending:
                        continue
                    sink = self.sinks[name]
                    for ack in sink.collect_acks():
                        # known_epoch advances ONLY from what the ack
                        # proves the engine serves. ``live`` is the
                        # engine's post-apply serving epoch (any kind);
                        # without it, only a swap ack counts — begin/
                        # leaf/discard acks set ``applied`` too, but
                        # "shadow opened" is not "epoch flipped", and
                        # treating it as such let a pre-commit failure
                        # leave known_epoch at the new epoch so the
                        # ensure_epoch retry no-op'd on stale weights.
                        if "live" in ack:
                            sink.known_epoch = max(
                                sink.known_epoch, int(ack["live"]))
                        elif (ack.get("kind") == "swap"
                                and ack.get("applied") is not None):
                            # swap True = flipped now; swap False = the
                            # exactly-once no-op (already at/past)
                            sink.known_epoch = max(
                                sink.known_epoch, int(ack["epoch"]))
                        seq = int(ack["seq"])
                        if seq not in pending:
                            # stale ack (e.g. a rolled-back stream's
                            # discard): seqs are never reused, so it
                            # cannot be one of ours
                            continue
                        pending.discard(seq)
                        doc["acked"][name] = max(
                            doc["acked"].get(name, -1), seq)
                if any(want.values()):
                    if time.monotonic() > deadline:
                        missing = {n: sorted(p)[:4]
                                   for n, p in want.items() if p}
                        raise TimeoutError(
                            f"wt stream unacked past "
                            f"{self.ack_timeout_s:.0f}s: {missing}")
                    time.sleep(0.002)

    # -- the journaled flip transaction -------------------------------------

    def publish_epoch(self, epoch: int, params: Dict[str, object], *,
                      layouts: Optional[dict] = None, src_mesh=None,
                      dst_mesh=None, dst_spec=None) -> dict:
        """Stream epoch ``epoch``'s (delta) weights to every engine and
        flip them, as one journaled transaction. Returns the closed
        journal entry. Raises on a pre-commit failure AFTER rolling the
        engines back (shadows discarded, doc retired ``rolled_back``);
        past commit the transaction only rolls forward."""
        epoch = int(epoch)
        t0 = time.monotonic()
        handle = _obs.start_span("weight_flip", epoch=epoch,
                                 engines=len(self.sinks))
        doc = {"id": f"wt-{epoch}", "epoch": epoch,
               "engines": sorted(self.sinks), "leaves": 0,
               "wire": self.wire, "bytes": 0, "acked": {}}
        self.journal.begin_weights(doc)
        chaos.weight_fence("publish")
        leaves = self._encode_leaves(params, layouts, src_mesh,
                                     dst_mesh, dst_spec)
        try:
            # -- stream: begin + changed leaves, per engine ----------------
            self.journal.advance_weights(doc, "stream")
            chaos.weight_fence("stream")
            # drop acks left over from a previous transaction (e.g. the
            # unawaited discards of a rollback) so they are never read
            # as this stream's — seqs are disjoint, but stale ``live``
            # values would be harmless and stale seq bookkeeping is not
            for sink in self.sinks.values():
                sink.collect_acks()
            want: Dict[str, set] = {}
            for name, sink in self.sinks.items():
                seqs = set()
                seq = self._seq[name]
                self._send(sink, encode_wt_frame(
                    WEIGHT_CHANNEL, seq, "begin", epoch))
                seqs.add(seq)
                seq += 1
                sent = self._digests[name]
                for leaf, payload, meta, digest, nbytes in leaves:
                    if sent.get(leaf) == digest:
                        continue  # bit-equal to what this engine holds
                    frame = {"t": "wt", "ch": WEIGHT_CHANNEL, "seq": seq,
                             "kind": "leaf", "epoch": epoch,
                             "name": leaf, "x": payload}
                    if meta:
                        frame["meta"] = meta
                    self._send(sink, frame)
                    doc["leaves"] += 1
                    doc["bytes"] += nbytes
                    _obs.inc("online_wt_bytes_total", nbytes,
                             engine=name)
                    seqs.add(seq)
                    seq += 1
                self._seq[name] = seq
                want[name] = seqs
            self._wait_acks(want, doc)
            # -- commit: the journal decides BEFORE the engines flip, so a
            # crash from here on rolls forward (re-publish converges) ------
            self.journal.advance_weights(doc, "commit")
            chaos.weight_fence("commit")
        except Exception:
            # pre-commit failure: discard every engine's shadow and retire
            # the doc as rolled back; nothing flipped. The discards are
            # best-effort — a dead sink must not mask the streaming error
            # (a shadow that survives an unreachable discard is replaced
            # wholesale by the next publish's begin frame)
            for name, sink in self.sinks.items():
                seq = self._seq[name]
                try:
                    sink.send(encode_wt_frame(
                        WEIGHT_CHANNEL, seq, "discard", epoch))
                except Exception:
                    pass
                self._seq[name] = seq + 1
            self.journal.close_weights(doc, "rolled_back")
            _obs.inc("online_flips_total", outcome="rolled_back")
            _obs.event("weight_flip_rollback", epoch=epoch)
            _obs.end_span(handle, outcome="rolled_back")
            raise
        # -- swap: pointer-flip orders, exactly-once via the no-op guard --
        self.journal.advance_weights(doc, "swap")
        chaos.weight_fence("swap")
        want = {}
        for name, sink in self.sinks.items():
            seq = self._seq[name]
            self._send(sink, encode_wt_frame(
                WEIGHT_CHANNEL, seq, "swap", epoch))
            self._seq[name] = seq + 1
            want[name] = {seq}
        self._wait_acks(want, doc)
        self.journal.advance_weights(doc, "finalize")
        chaos.weight_fence("finalize")
        # only now do the digests learn the new payloads: a rolled-back
        # stream must re-send its leaves next time
        for name in self.sinks:
            sent = self._digests[name]
            for leaf, _payload, _meta, digest, _nbytes in leaves:
                sent[leaf] = digest
        self.journal.close_weights(doc, "committed")
        dur = time.monotonic() - t0
        _obs.set_gauge("online_weight_epoch", float(epoch))
        _obs.observe("online_flip_seconds", dur)
        _obs.inc("online_flips_total", outcome="committed")
        _obs.event("weight_flip_commit", epoch=epoch,
                   leaves=doc["leaves"], bytes=doc["bytes"])
        _obs.end_span(handle, outcome="committed")
        return dict(doc, outcome="committed", seconds=dur)

    # -- crash recovery -----------------------------------------------------

    def recover(self) -> Optional[str]:
        """Resolve a weight transaction left open by a crash. Before
        ``commit``: discard any surviving engine shadows and retire the
        doc ``rolled_back``. At/past ``commit``: retire it
        ``rolled_forward`` — the shadow died with the publisher, so the
        flip itself converges through :meth:`ensure_epoch`'s idempotent
        re-publish, not through a blind swap replay. Returns the outcome
        or None when no transaction was pending."""
        from ..distributed.fleet.supervisor import (WEIGHT_COMMIT_INDEX,
                                                    WEIGHT_FENCES)
        doc = self.journal.pending_weights()
        if doc is None:
            return None
        epoch = int(doc["epoch"])
        past_commit = (WEIGHT_FENCES.index(doc.get("fence", "publish"))
                       >= WEIGHT_COMMIT_INDEX)
        for name, sink in self.sinks.items():
            seq = self._seq[name]
            try:
                sink.send(encode_wt_frame(
                    WEIGHT_CHANNEL, seq, "discard", epoch))
            except Exception:
                pass  # best-effort: recovery must retire the doc even
                # when an engine is unreachable; its shadow is replaced
                # by the next publish's begin frame
            self._seq[name] = seq + 1
        # the restarted publisher holds no digests for these engines, so
        # the next publish re-sends full state — correct by construction
        outcome = "rolled_forward" if past_commit else "rolled_back"
        self.journal.close_weights(doc, outcome)
        _obs.inc("online_flips_total", outcome=outcome)
        _obs.event("weight_flip_rollback", epoch=epoch, recovered=True,
                   outcome=outcome)
        return outcome

    def ensure_epoch(self, epoch: int,
                     params: Dict[str, object], **kw) -> dict:
        """Idempotent convergence: recover any crashed transaction, then
        (re-)publish until every engine serves ``epoch``. The trainer is
        deterministic, so a re-publish streams bit-equal values; the
        engines' no-op guards make the flip exactly-once."""
        epoch = int(epoch)
        self.recover()
        for sink in self.sinks.values():
            sink.pump()
        if all(s.known_epoch >= epoch for s in self.sinks.values()):
            return {"id": f"wt-{epoch}", "epoch": epoch,
                    "outcome": "already_current"}
        return self.publish_epoch(epoch, params, **kw)


def rollout_round(coord: OnlineCoordinator, epoch: int, *,
                  generate_fn: Callable[[], Sequence],
                  reward_fn: Callable[[object], float],
                  train_fn: Callable[[Sequence, Sequence[float]],
                                     Dict[str, object]]) -> dict:
    """One turn of the continuous-learning crank: the decode engines
    double as rollout workers. ``generate_fn`` samples rollouts from the
    live fleet (epoch ``epoch - 1``), ``reward_fn`` scores each one
    (pluggable — a verifier, a preference model, a unit test), and
    ``train_fn`` folds (rollouts, rewards) into the trainer and returns
    the updated param dict, which is then flipped into the fleet as
    ``epoch``. Returns the closed journal entry."""
    rollouts = list(generate_fn())
    rewards = [float(reward_fn(r)) for r in rollouts]
    params = train_fn(rollouts, rewards)
    return coord.ensure_epoch(epoch, params)
