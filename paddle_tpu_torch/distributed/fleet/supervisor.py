"""Fleet supervisor: the train/serve colocation control loop (counterpart
of ``paddle_tpu/distributed/fleet/supervisor.py``: plain Python, kept as
the port's own copy).

A control daemon that owns the fleet inventory — which workers are
serving engines and which are MPMD training stage capacity — reads the
live ``fleet_health.json`` (``observability/live.py``: per-SLO-class
error-budget burn rates + the router's admission-queue and
outstanding-token gauges), prices each candidate role flip via
``planner.plan_mpmd_stages``, and executes flips as **two-phase,
journaled, crash-recoverable transactions**.

Flip state machine (one named fence per transition, in order)::

    plan -> drain -> quiesce -> resize -> commit -> finalize

Every fence is journaled to an atomic on-disk flip log BEFORE the
fence's action runs (tmp + fsync + ``os.replace``), and
``chaos.flip_fence(name)`` fires right after the journal write — so a
supervisor SIGKILL at ANY fence leaves the journal durably recording
exactly how far the transaction got. Recovery reads it on startup and
restores a consistent fleet:

* fence **before** ``commit`` — roll BACK: the executor undoes whatever
  partial work the recorded fence implies (drain orders lifted, resize
  restored from the journaled source width) and the durable roles doc
  stays at the source assignment. No half-flipped worker is ever left
  serving a stale role.
* fence **at/after** ``commit`` — roll FORWARD: the target roles doc is
  (re)written and the executor's ``activate`` re-runs (idempotent by
  contract); the flip counts as committed.

Control-loop robustness: a flip needs its trigger signal to HOLD for
``hysteresis_s`` (one hot pump cannot thrash the fleet), committed flips
are spaced by ``cooldown_s``, and a flip-storm circuit breaker opens
when more than ``breaker_max_flips`` commit inside ``breaker_window_s``
— while open, the supervisor only observes. Breaker state is persisted
in the roles doc so a relaunched supervisor sees it.

The store/transport side effects live behind the ``FlipExecutor``
interface so the state machine is testable without a fleet;
``StoreFleetExecutor`` is the real one — drain orders through the
per-engine ctl key (serving/protocol.py), in-flight handoff through
``Router.evacuate`` (the failover resubmit path, equal reruns by
router-assigned seeds), training resize through a caller-supplied hook
(e.g. ``MpmdPipeline.resize_stage``).

The journal's weight-transaction methods (``begin_weights`` ...) are the
online weight-epoch transaction's; ``serving/online.py``'s
``OnlineCoordinator`` calls them.

This module is the single writer of the ``supervisor_*`` metric family
and the ``flip`` span, every store op sits under ``deadline_guard`` and
every journal write goes through the one atomic chokepoint
``_atomic_write_json``.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ... import observability as _obs
from ...serving.protocol import (DEFAULT_NAMESPACE, deadline_guard,
                                 k_ctl_engine, k_occ, pack, unpack)
from ...testing import chaos

__all__ = ["FENCES", "WEIGHT_FENCES", "FlipExecutor", "FlipJournal",
           "FleetSupervisor", "StoreFleetExecutor", "SupervisorConfig",
           "read_health"]

#: ordered flip-transition fences; ``commit`` is the durability point —
#: recovery rolls forward at/after it and back before it
FENCES = ("plan", "drain", "quiesce", "resize", "commit", "finalize")
COMMIT_INDEX = FENCES.index("commit")

#: ordered fences of the online WEIGHT-epoch transaction (the journal's
#: second transaction type, serving/online.py): ``commit`` is journaled
#: BEFORE the engine pointer-swaps, so roll-forward recovery re-sends
#: the idempotent swap orders (engines at/past the epoch no-op) and
#: roll-back discards shadow buffers that were never promoted
WEIGHT_FENCES = ("publish", "stream", "commit", "swap", "finalize")
WEIGHT_COMMIT_INDEX = WEIGHT_FENCES.index("commit")

#: committed/rolled-back flips kept in the journal's history log
_HISTORY_CAP = 64


def _atomic_write_json(path: str, doc: dict) -> None:
    """The ONE journal/roles write chokepoint: serialize, write to a tmp
    sibling, fsync, ``os.replace``. A SIGKILL at any instant leaves
    either the old doc or the new one on disk — never a torn file. Every
    write-mode ``open`` in this module is this function's."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    """Read a journal/roles/health doc; None when absent or torn (a torn
    doc can only be a crashed FOREIGN writer — ours are atomic)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_health(path: str) -> dict:
    """Load ``fleet_health.json`` (observability/live.py schema); an
    absent/torn doc reads as empty — the supervisor then simply holds
    (no signal is never a reason to flip)."""
    return _read_json(path) or {}


@dataclass
class SupervisorConfig:
    #: any class's burn rate at/above this (or an admission backlog at/
    #: above queue_high) is serving pressure -> flip capacity TO serving
    high_burn: float = 1.0
    #: every burn rate at/below this with empty admission queues is
    #: serving headroom -> flip an idle engine TO training
    low_burn: float = 0.5
    #: admitted-but-undispatched requests (all classes) that count as
    #: serving pressure even before latency burn shows it
    queue_high: int = 8
    #: the trigger signal must hold this long before a flip fires
    hysteresis_s: float = 2.0
    #: minimum spacing between committed flips
    cooldown_s: float = 5.0
    #: flip-storm circuit breaker: more than breaker_max_flips commits
    #: inside breaker_window_s opens the breaker for breaker_open_s
    breaker_window_s: float = 60.0
    breaker_max_flips: int = 4
    breaker_open_s: float = 30.0
    #: serving engines the supervisor must always leave in place
    min_serving: int = 1
    #: seconds a drain may take before in-flight work is handed off via
    #: the router's evacuate (failover resubmit) path
    drain_timeout_s: float = 30.0
    #: pricing: growing training by one worker must be predicted to cut
    #: the step time by at least this fraction, or the flip is skipped
    #: (diminishing-returns guard; serving-pressure flips always clear)
    min_speedup: float = 0.02
    #: MPMD stage count + boundary wire dtype handed to the planner
    plan_stages: int = 2
    wire: str = "f32"
    #: serving namespace for the store-side executor
    namespace: str = DEFAULT_NAMESPACE


@dataclass
class FlipDecision:
    direction: str                  # to_training | to_serving
    engine: str                     # worker being flipped
    reason: str                     # trigger that held through hysteresis
    price: dict = field(default_factory=dict)


class FlipJournal:
    """Atomic on-disk flip log + durable fleet roles doc.

    Layout under ``root``::

        fleet_roles.json   durable truth: {"roles": {name: role},
                           "training_width": int, "breaker_open_until":
                           wall ts or 0, "flips_committed": int}
        flip_current.json  the in-flight flip transaction (absent when
                           no flip is in flight); rewritten atomically
                           at every fence
        flip_log.json      bounded history of closed flips, newest last
        weights_current.json  the in-flight online weight-epoch
                           transaction (the reference's
                           serving/online.py), same
                           fence-before-action protocol over
                           WEIGHT_FENCES
        weight_log.json    bounded history of closed weight flips

    One flip is in flight at a time — the supervisor serializes role
    changes, which is what makes single-doc recovery sufficient. The
    weight transaction is serialized the same way (one epoch publishes
    at a time) and shares the atomic-write chokepoint.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.roles_path = os.path.join(root, "fleet_roles.json")
        self.current_path = os.path.join(root, "flip_current.json")
        self.history_path = os.path.join(root, "flip_log.json")
        self.weights_path = os.path.join(root, "weights_current.json")
        self.weight_history_path = os.path.join(root, "weight_log.json")

    # -- roles doc -----------------------------------------------------------

    def load_roles(self) -> Optional[dict]:
        return _read_json(self.roles_path)

    def save_roles(self, doc: dict) -> None:
        _atomic_write_json(self.roles_path, doc)

    # -- the in-flight flip --------------------------------------------------

    def pending(self) -> Optional[dict]:
        return _read_json(self.current_path)

    def begin(self, doc: dict) -> None:
        doc["fence"] = FENCES[0]
        doc["fences"] = {FENCES[0]: time.time()}
        _atomic_write_json(self.current_path, doc)

    def advance(self, doc: dict, fence: str) -> None:
        if fence not in FENCES:
            raise ValueError(f"unknown flip fence {fence!r}")
        doc["fence"] = fence
        doc["fences"][fence] = time.time()
        _atomic_write_json(self.current_path, doc)

    def close(self, doc: dict, outcome: str) -> None:
        """Retire the in-flight flip into the bounded history log, THEN
        drop the current doc — a kill between the two writes leaves a
        closed flip still pending, and re-closing it is idempotent."""
        entry = {k: doc.get(k) for k in
                 ("id", "direction", "engine", "reason", "fence", "fences",
                  "source_width", "target_width", "price")}
        entry["outcome"] = outcome
        entry["closed_ts"] = time.time()
        history = _read_json(self.history_path) or []
        history = [h for h in history if h.get("id") != entry["id"]]
        history.append(entry)
        _atomic_write_json(self.history_path, history[-_HISTORY_CAP:])
        try:
            os.remove(self.current_path)
        except OSError:
            pass

    def history(self) -> List[dict]:
        return _read_json(self.history_path) or []

    # -- the in-flight weight-epoch transaction (serving/online.py's) -------

    def pending_weights(self) -> Optional[dict]:
        return _read_json(self.weights_path)

    def begin_weights(self, doc: dict) -> None:
        doc["fence"] = WEIGHT_FENCES[0]
        doc["fences"] = {WEIGHT_FENCES[0]: time.time()}
        _atomic_write_json(self.weights_path, doc)

    def advance_weights(self, doc: dict, fence: str) -> None:
        if fence not in WEIGHT_FENCES:
            raise ValueError(f"unknown weight fence {fence!r}")
        doc["fence"] = fence
        doc["fences"][fence] = time.time()
        _atomic_write_json(self.weights_path, doc)

    def close_weights(self, doc: dict, outcome: str) -> None:
        """Retire the in-flight weight flip into its history log, THEN
        drop the current doc (same idempotent two-write order as
        ``close``)."""
        entry = {k: doc.get(k) for k in
                 ("id", "epoch", "engines", "fence", "fences", "leaves",
                  "wire", "bytes", "acked")}
        entry["outcome"] = outcome
        entry["closed_ts"] = time.time()
        history = _read_json(self.weight_history_path) or []
        history = [h for h in history if h.get("id") != entry["id"]]
        history.append(entry)
        _atomic_write_json(self.weight_history_path,
                           history[-_HISTORY_CAP:])
        try:
            os.remove(self.weights_path)
        except OSError:
            pass

    def weight_history(self) -> List[dict]:
        return _read_json(self.weight_history_path) or []


class FlipExecutor:
    """Side-effect interface of the flip state machine. The base class
    is a no-op fleet (unit tests subclass it to record/raise); the
    methods are the per-fence actions, each invoked AFTER its fence is
    journaled. ``activate`` and ``rollback`` must be idempotent — crash
    recovery may re-run them."""

    def drain(self, engine: str, deadline_s: float) -> bool:
        """Stop ``engine`` admitting new work; return True once its
        in-flight requests finished, False if the deadline expired and
        leftovers were handed off (failover resubmit path)."""
        return True

    def quiesce(self, engine: str) -> None:
        """``engine`` is drained: release its devices for their new
        role (nothing may still be running on them after this)."""

    def resize(self, source_width: int, target_width: int) -> None:
        """Grow/shrink the training side (e.g. ``resize_stage``)."""

    def activate(self, engine: str, role: str) -> None:
        """Bring ``engine`` up in its committed role (idempotent)."""

    def rollback(self, doc: dict) -> None:
        """Undo a pre-commit partial flip described by the journal doc
        (idempotent): lift drain orders, restore the source width."""


class StoreFleetExecutor(FlipExecutor):
    """The real executor: drain orders through the per-engine ctl key,
    drain progress watched via the engine's occupancy beat, leftover
    in-flight work handed off through ``router.evacuate`` (equal reruns —
    request seeds are router-assigned), training resize through a
    caller-supplied hook. ``pump`` (optional) is called while waiting so
    an in-process router keeps making progress."""

    def __init__(self, store, *, namespace: str = DEFAULT_NAMESPACE,
                 router=None, resize_fn: Optional[Callable] = None,
                 pump: Optional[Callable] = None, poll_s: float = 0.02):
        self._store = store
        self._ns = namespace
        self._router = router
        self._resize_fn = resize_fn
        self._pump = pump
        self._poll_s = poll_s

    def _order(self, engine: str, drain: bool) -> None:
        with deadline_guard("supervisor drain order"):
            self._store.set(k_ctl_engine(self._ns, engine),
                            pack({"drain": drain, "ts": time.time()}))

    def drain(self, engine: str, deadline_s: float) -> bool:
        self._order(engine, True)
        deadline = time.monotonic() + deadline_s
        key = k_occ(self._ns, engine)
        clean = False
        while time.monotonic() < deadline:
            if self._pump is not None:
                self._pump()
            with deadline_guard("supervisor poll drain"):
                have = self._store.check(key)
                occ = unpack(self._store.get(key)) if have else {}
            if occ.get("drained"):
                clean = True
                break
            time.sleep(self._poll_s)
        if self._router is not None:
            # hand the book back even after a CLEAN drain: the worker
            # stops consuming dispatch seqs on the drain edge, so
            # dispatched-but-never-admitted requests are stranded on its
            # queue — evacuate harvests the finished rids and requeues
            # the rest (bit-equal reruns, router-assigned seeds)
            self._router.evacuate(engine)
        return clean

    def resize(self, source_width: int, target_width: int) -> None:
        if self._resize_fn is not None:
            self._resize_fn(source_width, target_width)

    def activate(self, engine: str, role: str) -> None:
        # a serving engine resumes admission; a training worker keeps
        # its drain order so it never re-admits behind the fleet's back
        self._order(engine, drain=(role != "serving"))

    def rollback(self, doc: dict) -> None:
        engine = doc.get("engine")
        if engine:
            src_role = doc.get("source_roles", {}).get(engine, "serving")
            self._order(engine, drain=(src_role != "serving"))
        if self._resize_fn is not None and doc.get("resized"):
            self._resize_fn(doc.get("target_width"),
                            doc.get("source_width"))


class FleetSupervisor:
    """Own the fleet inventory and close the SLO control loop.

    ``tick()`` is the loop body: read the health doc, hold the trigger
    through hysteresis/cooldown/breaker, price the flip, execute it as
    a journaled transaction. Construction runs ``recover()`` first, so
    a relaunched supervisor always starts from a consistent fleet.
    """

    def __init__(self, journal_dir: str, *,
                 executor: Optional[FlipExecutor] = None,
                 config: Optional[SupervisorConfig] = None,
                 health_path: Optional[str] = None,
                 roles: Optional[Dict[str, str]] = None,
                 training_width: int = 0):
        self.config = config or SupervisorConfig()
        self.executor = executor or FlipExecutor()
        self.journal = FlipJournal(journal_dir)
        self.health_path = health_path
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_commit_t = -float("inf")
        self._commit_times: List[float] = []
        self._next_flip_id = int(time.time())
        self.last_outcome: Optional[str] = None
        self.recover()
        if self.journal.load_roles() is None:
            self.journal.save_roles({
                "roles": dict(roles or {}),
                "training_width": int(training_width),
                "breaker_open_until": 0.0,
                "flips_committed": 0,
            })
        self._export_role_gauges()

    # -- inventory -----------------------------------------------------------

    @property
    def roles_doc(self) -> dict:
        return self.journal.load_roles() or {
            "roles": {}, "training_width": 0,
            "breaker_open_until": 0.0, "flips_committed": 0}

    def _count(self, doc: dict, role: str) -> int:
        return sum(1 for r in doc["roles"].values() if r == role)

    def _export_role_gauges(self) -> None:
        doc = self.roles_doc
        for role in ("serving", "training"):
            _obs.set_gauge("supervisor_fleet_roles",
                           self._count(doc, role), role=role)
        _obs.set_gauge(
            "supervisor_breaker_open",
            1.0 if doc.get("breaker_open_until", 0) > time.time() else 0.0)

    # -- crash recovery ------------------------------------------------------

    def recover(self) -> Optional[str]:
        """Resolve a flip the previous supervisor left in flight. Rolls
        forward at/after the commit fence, back before it; returns the
        outcome ("rolled_forward" | "rolled_back") or None."""
        doc = self.journal.pending()
        if doc is None:
            return None
        fence = doc.get("fence", FENCES[0])
        idx = FENCES.index(fence) if fence in FENCES else 0
        if idx >= COMMIT_INDEX:
            # committed: finish the flip — target roles are the truth
            self.journal.save_roles(doc["target_roles_doc"])
            self.executor.activate(doc["engine"], doc["target_role"])
            self.journal.close(doc, "rolled_forward")
            _obs.inc("supervisor_flips_total", direction=doc["direction"])
            _obs.event("flip_commit", id=doc["id"],
                       direction=doc["direction"], engine=doc["engine"],
                       recovered=True, fence=fence)
            outcome = "rolled_forward"
        else:
            # not committed: the source assignment stays the truth
            self.executor.rollback(doc)
            self.journal.save_roles(doc["source_roles_doc"])
            self.journal.close(doc, "rolled_back")
            _obs.inc("supervisor_rollbacks_total")
            _obs.event("flip_rollback", id=doc["id"],
                       direction=doc["direction"], engine=doc["engine"],
                       recovered=True, fence=fence)
            outcome = "rolled_back"
        self.last_outcome = outcome
        self._export_role_gauges()
        return outcome

    # -- pricing -------------------------------------------------------------

    def price(self, direction: str) -> dict:
        """Price the candidate flip with the MPMD stage planner: the
        predicted training step time at the current vs the flipped
        width (boundary bytes at the resolved wire dtype ride along so
        the journal records WHY). A training side of width 0 prices as
        idle (any growth approves; nothing to shrink-price)."""
        doc = self.roles_doc
        width = int(doc.get("training_width", 0))
        target = width + 1 if direction == "to_training" else width - 1
        out = {"source_width": width, "target_width": target,
               "approve": True}

        def _step_s(w: int) -> Optional[dict]:
            if w < 1:
                return None
            from ..auto_parallel.planner import (Topology,
                                                 plan_mpmd_stages)
            stages = max(1, min(self.config.plan_stages, w))
            plan = plan_mpmd_stages(
                topology=Topology(n_devices=w), num_stages=stages,
                wire=self.config.wire)
            return {"predicted_step_s": plan.best.predicted_step_s,
                    "widths": list(plan.best.widths),
                    "boundary_bytes": plan.best.boundary_bytes,
                    "plan_seconds": plan.plan_seconds}

        try:
            out["source"] = _step_s(width)
            out["target"] = _step_s(target)
        except Exception as e:  # planner missing calibration etc.
            out["error"] = str(e)
            return out
        if direction == "to_training" and out["source"] and out["target"]:
            old = out["source"]["predicted_step_s"]
            new = out["target"]["predicted_step_s"]
            out["speedup"] = old / new if new > 0 else float("inf")
            out["approve"] = out["speedup"] >= 1.0 + self.config.min_speedup
        return out

    # -- decision ------------------------------------------------------------

    @staticmethod
    def _signals(health: dict) -> dict:
        """Collapse a fleet_health.json doc to the two control inputs:
        the worst burn rate across classes/objectives and the total
        admission backlog."""
        burn = 0.0
        for cls in (health.get("classes") or {}).values():
            obj = cls.get("objectives") or {}
            for k in ("burn_rate_latency", "burn_rate_availability"):
                if obj.get(k) is not None:
                    burn = max(burn, float(obj[k]))
        queues = health.get("queues") or {}
        admission = queues.get("admission") or {}
        backlog = sum(int(v) for v in admission.values()) \
            if isinstance(admission, dict) else int(admission or 0)
        return {"max_burn": burn, "admission_backlog": backlog}

    def decide(self, health: dict, now: float) -> Optional[FlipDecision]:
        """Hysteresis + cooldown + breaker gate around the raw signals;
        returns the flip to execute, or None to hold."""
        doc = self.roles_doc
        sig = self._signals(health)
        pressure = (sig["max_burn"] >= self.config.high_burn
                    or sig["admission_backlog"] >= self.config.queue_high)
        idle = (sig["max_burn"] <= self.config.low_burn
                and sig["admission_backlog"] == 0)
        self._pressure_since = (self._pressure_since or now) if pressure \
            else None
        self._idle_since = (self._idle_since or now) if idle else None
        if doc.get("breaker_open_until", 0) > time.time():
            return None
        if now - self._last_commit_t < self.config.cooldown_s:
            return None
        held = self.config.hysteresis_s
        if (pressure and now - self._pressure_since >= held
                and self._count(doc, "training") > 0):
            engine = sorted(n for n, r in doc["roles"].items()
                            if r == "training")[0]
            return FlipDecision(
                "to_serving", engine,
                f"burn={sig['max_burn']:.2f} "
                f"backlog={sig['admission_backlog']}",
                self.price("to_serving"))
        if (idle and now - self._idle_since >= held
                and self._count(doc, "serving") > self.config.min_serving):
            engine = sorted(n for n, r in doc["roles"].items()
                            if r == "serving")[-1]
            price = self.price("to_training")
            if not price.get("approve", False):
                return None
            return FlipDecision(
                "to_training", engine,
                f"burn={sig['max_burn']:.2f} idle", price)
        return None

    # -- the transaction -----------------------------------------------------

    def flip(self, decision: FlipDecision, now: Optional[float] = None) \
            -> str:
        """Execute one role flip as the journaled two-phase transaction.
        Returns "committed" or "rolled_back". Any executor failure
        before the commit fence rolls back; chaos SIGKILLs are resolved
        by ``recover()`` on the next launch."""
        now = time.monotonic() if now is None else now
        src_doc = self.roles_doc
        target_role = ("training" if decision.direction == "to_training"
                       else "serving")
        source_role = src_doc["roles"].get(decision.engine, "serving")
        tgt_doc = json.loads(json.dumps(src_doc))
        tgt_doc["roles"][decision.engine] = target_role
        delta = 1 if decision.direction == "to_training" else -1
        tgt_doc["training_width"] = max(
            0, int(src_doc.get("training_width", 0)) + delta)
        tgt_doc["flips_committed"] = \
            int(src_doc.get("flips_committed", 0)) + 1
        doc = {
            "id": self._next_flip_id,
            "direction": decision.direction,
            "engine": decision.engine,
            "reason": decision.reason,
            "price": decision.price,
            "source_role": source_role,
            "target_role": target_role,
            "source_roles": dict(src_doc["roles"]),
            "source_width": int(src_doc.get("training_width", 0)),
            "target_width": int(tgt_doc["training_width"]),
            "source_roles_doc": src_doc,
            "target_roles_doc": tgt_doc,
            "resized": False,
        }
        self._next_flip_id += 1
        t0 = time.perf_counter()
        handle = _obs.start_span("flip", direction=decision.direction,
                                 engine=decision.engine, id=doc["id"])
        self.journal.begin(doc)
        chaos.flip_fence("plan")
        try:
            self.journal.advance(doc, "drain")
            chaos.flip_fence("drain")
            if decision.direction == "to_training":
                doc["drained_clean"] = self.executor.drain(
                    decision.engine, self.config.drain_timeout_s)
            self.journal.advance(doc, "quiesce")
            chaos.flip_fence("quiesce")
            self.executor.quiesce(decision.engine)
            self.journal.advance(doc, "resize")
            chaos.flip_fence("resize")
            self.executor.resize(doc["source_width"], doc["target_width"])
            doc["resized"] = True
        except Exception as e:
            doc["error"] = str(e)
            self.executor.rollback(doc)
            self.journal.save_roles(doc["source_roles_doc"])
            self.journal.close(doc, "rolled_back")
            _obs.inc("supervisor_rollbacks_total")
            _obs.event("flip_rollback", id=doc["id"],
                       direction=decision.direction,
                       engine=decision.engine, fence=doc["fence"],
                       error=str(e))
            _obs.end_span(handle, outcome="rolled_back")
            self.last_outcome = "rolled_back"
            self._export_role_gauges()
            return "rolled_back"
        # COMMIT POINT: once the journal records this fence, recovery
        # rolls forward — the target assignment is the durable truth
        self.journal.advance(doc, "commit")
        chaos.flip_fence("commit")
        self.journal.save_roles(doc["target_roles_doc"])
        self.journal.advance(doc, "finalize")
        chaos.flip_fence("finalize")
        self.executor.activate(decision.engine, target_role)
        self.journal.close(doc, "committed")
        self._last_commit_t = now
        self._commit_times.append(now)
        self._pressure_since = None
        self._idle_since = None
        _obs.inc("supervisor_flips_total", direction=decision.direction)
        _obs.observe("supervisor_flip_duration_seconds",
                     time.perf_counter() - t0)
        _obs.event("flip_commit", id=doc["id"],
                   direction=decision.direction, engine=decision.engine,
                   reason=decision.reason,
                   drained_clean=doc.get("drained_clean"),
                   source_width=doc["source_width"],
                   target_width=doc["target_width"])
        _obs.end_span(handle, outcome="committed")
        self.last_outcome = "committed"
        self._check_breaker(now)
        self._export_role_gauges()
        return "committed"

    def _check_breaker(self, now: float) -> None:
        w = self.config.breaker_window_s
        self._commit_times = [t for t in self._commit_times
                              if now - t <= w]
        if len(self._commit_times) > self.config.breaker_max_flips:
            doc = self.roles_doc
            doc["breaker_open_until"] = \
                time.time() + self.config.breaker_open_s
            self.journal.save_roles(doc)
            _obs.event("supervisor_breaker", state="open",
                       flips_in_window=len(self._commit_times),
                       window_s=w, open_s=self.config.breaker_open_s)

    # -- the loop body -------------------------------------------------------

    def tick(self, health: Optional[dict] = None,
             now: Optional[float] = None) -> Optional[str]:
        """One control-loop round: signals -> decision -> transaction.
        ``health``/``now`` are injectable for deterministic tests; the
        default reads ``health_path`` and the monotonic clock. Returns
        the flip outcome or None when holding."""
        if health is None:
            health = read_health(self.health_path) \
                if self.health_path else {}
        now = time.monotonic() if now is None else now
        decision = self.decide(health, now)
        self._export_role_gauges()
        if decision is None:
            return None
        return self.flip(decision, now)
