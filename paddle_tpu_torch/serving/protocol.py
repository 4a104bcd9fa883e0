"""Router <-> engine-worker coordination protocol over the store
(counterpart of ``paddle_tpu/serving/protocol.py``: the same key schema,
the same pickled records, so the port's router and workers speak the
reference's protocol).

The serving plane splits control from data. The coordination store (the
port's ``runtime.TCPStore``)
is the GROUND TRUTH for membership and failover: engine workers register
under a namespace, publish occupancy beats, and persist every finished
request's ``done`` key there. The per-request hot path — dispatch,
completion acks, token/KV streams — normally rides the direct streaming
sockets in ``serving/transport.py`` instead; the ``req`` keys below are
the legacy store dataplane, kept fully working behind the router's
``dataplane="store"`` A/B switch and as the fallback when a worker's
socket drops mid-dispatch. Either way the crash-safety contract is the
store's: a ``done`` key is written before the occupancy ack, so a dead
worker's finished work is always harvestable.

Key schema (all under one namespace, default ``__srv``)::

    {ns}/count            engine counter: ``add(key, 1) - 1`` is a fresh
                          engine index (race-free discovery — ``add`` is
                          the store's atomic fetch-and-add)
    {ns}/engine/{i}       registration record of engine index i (carries
                          ``addr`` — the worker's transport listen
                          address the router dials — plus ``role``:
                          prefill | decode | unified, and ``kv_wire``)
    {ns}/occ/{name}       occupancy beat of engine `name` (monotone
                          ``beat`` field; a stalled beat past the grace
                          window means the worker is dead)
    {ns}/req/{name}/{seq} request seq dispatched to engine `name` on the
                          legacy store dataplane or the socket-failure
                          fallback (workers consume their stream in seq
                          order and ack via ``acked_seq``; the streaming
                          transport reuses the SAME seq numbering, so a
                          worker drains wire and store dispatches as one
                          stream).
                          With telemetry on, the record carries a
                          ``trace`` dict — ``{"trace_id", "parent_id",
                          "resubmits", "dispatch_ts"}`` — next to the
                          router-assigned seed; the worker and engine
                          continue that trace (observability/tracing.py)
                          so one request is one span tree across all
                          three processes. Absent when telemetry is off:
                          tracing adds zero wire bytes when disabled.
                          With tenant accounting on
                          (observability/accounting.py), a non-default
                          ``tenant`` label travels the same way — a
                          ``tenant`` + ``slo`` pair on the record (and
                          on disaggregated KV handoff payloads) that the
                          engine meters usage under. Requests without a
                          tenant add zero wire bytes and land on the
                          ledger's ``"-"`` default — the same disabled-
                          path contract as ``trace``.
    {ns}/done/{rid}       completed token stream of router request `rid`
                          (written BEFORE the occupancy ack, so failover
                          can harvest finished work from a dead engine)
    {ns}/ctl              router shutdown broadcast
    {ns}/ctl/{name}       per-engine control record (fleet supervisor
                          drain/resume orders for role flips)

Values are pickled python dicts (``pack``/``unpack``): the store is a
trusted same-job coordination plane, exactly like the launch rendezvous
that already rides it.

Every store op in router.py / worker.py sits under ``deadline_guard``.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import sys
import threading
from typing import Optional

DEFAULT_NAMESPACE = "__srv"

#: worker roles: ``unified`` prefills and decodes its own requests,
#: ``prefill`` exports KV pages to a decode worker, ``decode`` imports them
ROLES = ("unified", "prefill", "decode")

#: SLO classes in ascending priority; overload sheds the lowest first.
SLO_CLASSES = ("batch", "standard", "interactive")

#: per-class default deadline budget (seconds from submit); a request
#: still queued past its deadline is shed, not dispatched late.
DEFAULT_DEADLINES = {"interactive": 30.0, "standard": 120.0, "batch": 600.0}

#: Declared per-class service objectives — the targets the live telemetry
#: plane (observability/live.py) burns error budget against. Two
#: objectives per class:
#:
#:   * latency: ``latency_slo`` of requests must finish within
#:     ``latency_target_s`` (e.g. interactive: 95% under 2s). The error
#:     budget is ``1 - latency_slo``; the burn rate is the observed
#:     over-target fraction divided by that budget — 1.0 means the budget
#:     is being consumed exactly as fast as it accrues, >1.0 means an
#:     eventual SLO violation if sustained.
#:   * availability: ``availability_slo`` of admitted requests must
#:     complete (not shed, not failed). Same burn-rate convention.
#:
#: Tuned for the proxy fleet the benches drive (tiny models, CPU XLA);
#: a real deployment would override these per product surface. Every
#: class in SLO_CLASSES has an entry — observability/live.py and the
#: post-hoc trace summary both key off this table, so the live and
#: batch burn rates are definitionally comparable.
SLO_OBJECTIVES = {
    "interactive": {"latency_target_s": 2.0, "latency_slo": 0.95,
                    "availability_slo": 0.999},
    "standard": {"latency_target_s": 10.0, "latency_slo": 0.95,
                 "availability_slo": 0.995},
    "batch": {"latency_target_s": 60.0, "latency_slo": 0.90,
              "availability_slo": 0.99},
}


def k_count(ns: str) -> str:
    return f"{ns}/count"


def k_engine(ns: str, index: int) -> str:
    return f"{ns}/engine/{index}"


def k_occ(ns: str, name: str) -> str:
    return f"{ns}/occ/{name}"


def k_req(ns: str, name: str, seq: int) -> str:
    return f"{ns}/req/{name}/{seq}"


def k_done(ns: str, rid: int) -> str:
    return f"{ns}/done/{rid}"


def k_ctl(ns: str) -> str:
    return f"{ns}/ctl"


def k_ctl_engine(ns: str, name: str) -> str:
    """Per-engine control record (fleet supervisor drain/resume orders).
    A worker polls it at the slow ctl cadence; ``{"drain": True}`` makes
    it stop admitting new dispatches while finishing in-flight work (its
    occupancy beat then advertises ``draining``/``drained`` so the
    router and the supervisor can watch the drain converge)."""
    return f"{ns}/ctl/{name}"


def pack(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def unpack(data):
    return pickle.loads(bytes(data))


def _deadline_seconds() -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_SERVING_TIMEOUT", "120"))
    except ValueError:
        return 120.0


@contextlib.contextmanager
def deadline_guard(what: str, seconds: Optional[float] = None):
    """Bound a router/worker store op the way reshard.deadline_guard
    bounds collectives: a watchdog timer fires if the op stalls past the
    deadline (store peer dead, network wedge), prints a diagnosis naming
    the op, and raises TimeoutError once the block exits — a serving
    control-plane stall becomes a diagnosed failure instead of a silent
    router hang. Every store call site in ``serving/`` sits inside this
    guard."""
    limit = _deadline_seconds() if seconds is None else float(seconds)
    fired = threading.Event()

    def _stall():
        fired.set()
        print(f"[serving] store op {what!r} exceeded its {limit:.0f}s "
              "deadline — coordination store unreachable or peer wedged; "
              "raise PADDLE_TPU_SERVING_TIMEOUT for slow fabrics",
              file=sys.stderr, flush=True)

    timer = threading.Timer(limit, _stall)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
    if fired.is_set():
        raise TimeoutError(
            f"serving store op {what!r} exceeded its {limit:.0f}s deadline")
