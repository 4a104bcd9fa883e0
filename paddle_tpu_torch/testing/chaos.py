"""Deterministic fault injection for crash-safety testing (counterpart of
``paddle_tpu/testing/chaos.py``, ported whole: the same knobs, the same
fences, the same fault schedule for a given seed).

The harness injects real fleet faults (killed workers, torn checkpoint
writes, dead rendezvous peers, severed sockets) ON DEMAND so the
crash-safety guarantees are tested instead of hoped for. Everything is
inert unless PADDLE_CHAOS=1, and every fault is deterministic given the
seed knobs — a failing soak run reproduces byte-for-byte.

Wired in the port: ``engine_fence`` (``serving/worker.py``, before each
scheduler step), ``net_fence`` (``serving/transport.py``, before each
frame send), the store faults (``runtime/py_store.py``),
``reshard_fence`` (``distributed/reshard.py``, before each leaf and each
planned step), ``on_commit`` / ``after_commit`` (the checkpoint writer's
commit, ``distributed/checkpoint/__init__.py``) and ``mpmd_fence``
(``distributed/mpmd.py``, before each stage op). ``step_fence`` is the
training loop's to call, once a step. ``flip_fence`` is the fleet
supervisor's (``distributed/fleet/supervisor.py``), at each flip fence,
and ``weight_fence`` the online weight coordinator's
(``serving/online.py``), at each weight-transaction fence and before each
``wt`` frame it sends.

Env knobs (all read lazily so tests can flip them per-case):

  PADDLE_CHAOS=1                    master switch; nothing fires without it
  PADDLE_CHAOS_SEED=<int>           rng seed (default 0), mixed with
                                    PADDLE_TRAINER_ID so ranks draw
                                    independent-but-reproducible streams
  PADDLE_CHAOS_ONCE=0|1             faults fire only on the first launch
                                    attempt (PADDLE_RESTART_COUNT==0);
                                    default 1 so a relaunched worker runs
                                    clean and the job converges
  PADDLE_CHAOS_KILL_STEP=<k>        step_fence(k) delivers SIGKILL to self
                                    (the `kill -9 ` mid-training fault)
  PADDLE_CHAOS_CKPT_MODE=crash|torn|corrupt
  PADDLE_CHAOS_CKPT_STEP=<k>        which step's save the checkpoint fault
                                    applies to (default: every armed save)
      crash   — SIGKILL between the checkpoint body write and its commit
                (manifest + rename): simulates dying mid-save; only a
                .ptsave-tmp dir is left, never a half `step_k/`
      torn    — emulate the legacy non-atomic writer dying: the final
                `step_k/` name appears WITHOUT a manifest and with one
                file truncated, then SIGKILL; resume must skip it
      corrupt — commit normally, then flip bytes in the largest data file
                (manifest left stale): resume-time checksum verification
                must reject it
  PADDLE_CHAOS_STORE_DROP=<p>       per-op probability the client store
                                    connection is dropped before send
  PADDLE_CHAOS_STORE_LATENCY_MS=<ms>  artificial latency per store op
  PADDLE_CHAOS_RESHARD_MODE=kill|latency
  PADDLE_CHAOS_RESHARD_AT=<k>       which reshard fence the fault fires at
                                    (fences count planned collective steps
                                    across a reshard; default 0 = first)
  PADDLE_CHAOS_RESHARD_LATENCY_MS=<ms>  sleep injected by the latency mode
  PADDLE_CHAOS_ENGINE_MODE=kill|latency
  PADDLE_CHAOS_ENGINE_AT=<k>        which serving decode step the engine
                                    fault fires before (serving/worker.py
                                    fences every scheduler step; default 0)
  PADDLE_CHAOS_ENGINE_LATENCY_MS=<ms>  sleep injected by the latency mode
  PADDLE_CHAOS_FLIP_MODE=kill|latency
  PADDLE_CHAOS_FLIP_AT=<fence>      which named supervisor flip fence the
                                    fault fires at (fleet supervisor role
                                    flips journal a fence before every
                                    transition: plan|drain|quiesce|
                                    resize|commit|finalize)
  PADDLE_CHAOS_FLIP_SKIP=<n>        skip the first n matching flip fences
                                    before firing (targets the n+1-th
                                    flip of a run; default 0)
  PADDLE_CHAOS_FLIP_LATENCY_MS=<ms> sleep injected by the latency mode
  PADDLE_CHAOS_WEIGHT_MODE=kill|latency
  PADDLE_CHAOS_WEIGHT_AT=<fence>    which named weight-flip fence the fault
                                    fires at (serving/online.py journals a
                                    fence before every weight-transaction
                                    transition: publish|stream|wt:<seq>|
                                    commit|swap|finalize — wt:<seq> targets
                                    the send of one streamed weight frame)
  PADDLE_CHAOS_WEIGHT_SKIP=<n>      skip the first n matching weight fences
                                    before firing (targets a later epoch's
                                    flip; default 0)
  PADDLE_CHAOS_WEIGHT_LATENCY_MS=<ms> sleep injected by the latency mode
  PADDLE_CHAOS_NET_MODE=drop|half_open|latency
  PADDLE_CHAOS_NET_AT=<k>           which transport frame send the network
                                    fault fires at (serving/transport.py
                                    fences every frame send; default 0)
      drop      — sever the connection before the frame goes out (the
                  sender must reconnect with backoff; the frame is lost)
      half_open — swallow the frame but report success (the TCP half-open
                  fault: sender believes delivery, receiver sees nothing;
                  recovery is ack-stall retransmit or store ground truth)
      latency   — sleep PADDLE_CHAOS_NET_LATENCY_MS, then send normally
  PADDLE_CHAOS_NET_LATENCY_MS=<ms>  sleep injected by the latency mode

The tear/corrupt helpers at the bottom are also callable directly from
tests (no env needed) to manufacture damaged checkpoints.
"""
from __future__ import annotations

import os
import random
import shutil
import signal
import sys
import time
from typing import List, Optional, Tuple

from .. import observability as _obs

_rng: Optional[random.Random] = None


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    return default if v in (None, "") else v


def enabled() -> bool:
    return _env("PADDLE_CHAOS", "0") not in ("0", None)


def attempt() -> int:
    """Which launch attempt this process is (launch CLI exports
    PADDLE_RESTART_COUNT to relaunched workers)."""
    try:
        return int(_env("PADDLE_RESTART_COUNT", "0"))
    except ValueError:
        return 0


def armed() -> bool:
    """Faults fire only when chaos is on AND (unless PADDLE_CHAOS_ONCE=0)
    this is the first launch attempt — a relaunched worker must run clean
    so kill-and-resume soaks converge."""
    if not enabled():
        return False
    if _env("PADDLE_CHAOS_ONCE", "1") != "0" and attempt() != 0:
        return False
    return True


def rng() -> random.Random:
    """Per-process deterministic stream: seed mixed with the rank so every
    rank draws an independent but reproducible fault schedule."""
    global _rng
    if _rng is None:
        seed = int(_env("PADDLE_CHAOS_SEED", "0"))
        rank = int(_env("PADDLE_TRAINER_ID", "0"))
        _rng = random.Random((seed << 16) ^ (rank + 1))
    return _rng


def reset() -> None:
    """Drop cached rng/fence state (tests flipping env knobs
    mid-process)."""
    global _rng, _flip_fence_hits, _weight_fence_hits
    _rng = None
    _flip_fence_hits = 0
    _weight_fence_hits = 0


def _log(msg: str) -> None:
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


def _fault(fault: str, **fields) -> None:
    """Record an injected fault in the telemetry stream (counter + JSONL
    event), so soak runs yield an auditable fault-vs-recovery timeline.
    The event write is unbuffered append — it survives the SIGKILL that
    usually follows."""
    _obs.inc("chaos_fault_total", fault=fault)
    _obs.event("chaos_fault", fault=fault, attempt=attempt(), **fields)


def _sigkill(why: str) -> None:
    _log(f"{why} -> SIGKILL pid {os.getpid()}")
    os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# Training-loop faults
# ---------------------------------------------------------------------------
def step_fence(step: int) -> None:
    """Call once per training step; delivers the configured mid-training
    `kill -9` when the step matches PADDLE_CHAOS_KILL_STEP."""
    if not armed():
        return
    k = _env("PADDLE_CHAOS_KILL_STEP")
    if k is not None and int(k) == step:
        _fault("kill_step", step=step)
        _sigkill(f"kill injected at train step {step}")


# ---------------------------------------------------------------------------
# Reshard faults (called by distributed/reshard.py between planned steps)
# ---------------------------------------------------------------------------
def reshard_fence(index: int, what: str) -> None:
    """Fault point between planned reshard collective steps. ``index``
    counts fences across one reshard (leaf boundaries and per-step), so
    PADDLE_CHAOS_RESHARD_AT can target "mid-reshard" precisely: some
    leaves already moved, others not — the window a real preemption tears.

    kill    — SIGKILL at the matching fence; recovery must come from the
              newest verified checkpoint, never the half-moved state.
    latency — sleep PADDLE_CHAOS_RESHARD_LATENCY_MS at the matching fence,
              exercising the reshard deadline watchdog.
    """
    if not armed():
        return
    mode = _env("PADDLE_CHAOS_RESHARD_MODE")
    if mode is None:
        return
    at = int(_env("PADDLE_CHAOS_RESHARD_AT", "0"))
    if index != at:
        return
    if mode == "kill":
        _fault("reshard_kill", index=index, what=what)
        _sigkill(f"kill injected at reshard fence {index} ({what})")
    elif mode == "latency":
        ms = float(_env("PADDLE_CHAOS_RESHARD_LATENCY_MS", "0"))
        _fault("reshard_latency", index=index, what=what, ms=ms)
        if ms > 0:
            time.sleep(ms / 1000.0)


# ---------------------------------------------------------------------------
# MPMD stage faults (called by distributed/mpmd.py before each stage op)
# ---------------------------------------------------------------------------
def mpmd_fence(stage: int, index: int) -> None:
    """Fault point before an MPMD stage runner executes its next schedule
    op. ``index`` counts that stage's (F/B, microbatch) ops within one
    step, so PADDLE_CHAOS_MPMD_AT + PADDLE_CHAOS_MPMD_STAGE can target
    "stage s, mid-tick" precisely: some microbatches forwarded, boundary
    queues holding unacked activations — the window per-stage shard
    restore + queue replay must cover.

    kill    — SIGKILL at the matching op; recovery restores every stage
              at ``latest_common_step`` and replays the step bit-equal.
    latency — sleep PADDLE_CHAOS_MPMD_LATENCY_MS at the matching op,
              exercising the boundary-queue deadline watchdog.
    """
    if not armed():
        return
    mode = _env("PADDLE_CHAOS_MPMD_MODE")
    if mode is None:
        return
    if int(_env("PADDLE_CHAOS_MPMD_STAGE", "0")) != stage:
        return
    if int(_env("PADDLE_CHAOS_MPMD_AT", "0")) != index:
        return
    if mode == "kill":
        _fault("mpmd_kill", stage=stage, index=index)
        _sigkill(f"kill injected at mpmd stage {stage} op {index}")
    elif mode == "latency":
        ms = float(_env("PADDLE_CHAOS_MPMD_LATENCY_MS", "0"))
        _fault("mpmd_latency", stage=stage, index=index, ms=ms)
        if ms > 0:
            time.sleep(ms / 1000.0)


# ---------------------------------------------------------------------------
# Fleet-supervisor flip faults (distributed/fleet/supervisor.py fences)
# ---------------------------------------------------------------------------
_flip_fence_hits = 0


def flip_fence(fence: str) -> None:
    """Fault point at a named supervisor flip-transition fence. The
    supervisor journals each fence BEFORE calling this, so a kill here
    leaves the flip journal durably recording exactly how far the
    transaction got — the recovery contract (roll forward at/after
    ``commit``, roll back before it) is what the soak exercises.

    Fences are matched by NAME (``PADDLE_CHAOS_FLIP_AT``), not index:
    plan | drain | quiesce | resize | commit | finalize.
    ``PADDLE_CHAOS_FLIP_SKIP`` skips the first n matches so a soak can
    target the same fence on a later flip (e.g. the to_serving leg).

    kill    — SIGKILL at the matching fence; the relaunched supervisor
              must recover a consistent fleet from the journal alone.
    latency — sleep PADDLE_CHAOS_FLIP_LATENCY_MS at the matching fence,
              exercising the flip deadline/drain-timeout guards.
    """
    global _flip_fence_hits
    if not armed():
        return
    mode = _env("PADDLE_CHAOS_FLIP_MODE")
    if mode is None:
        return
    if _env("PADDLE_CHAOS_FLIP_AT") != fence:
        return
    skip = int(_env("PADDLE_CHAOS_FLIP_SKIP", "0"))
    _flip_fence_hits += 1
    if _flip_fence_hits <= skip:
        return
    if mode == "kill":
        _fault("flip_kill", fence=fence, hit=_flip_fence_hits)
        _sigkill(f"kill injected at supervisor flip fence {fence!r}")
    elif mode == "latency":
        ms = float(_env("PADDLE_CHAOS_FLIP_LATENCY_MS", "0"))
        _fault("flip_latency", fence=fence, ms=ms)
        if ms > 0:
            time.sleep(ms / 1000.0)


# ---------------------------------------------------------------------------
# Online weight-flip faults (serving/online.py weight-transaction fences)
# ---------------------------------------------------------------------------
_weight_fence_hits = 0


def weight_fence(fence: str) -> None:
    """Fault point at a named online weight-transaction fence. The
    coordinator journals each fence BEFORE calling this (same discipline
    as ``flip_fence``), so a kill here leaves ``weights_current.json``
    durably recording exactly how far the epoch flip got — recovery
    rolls forward at/after ``commit`` (re-issuing the idempotent swap
    orders) and back before it (discarding shadow buffers).

    Fences are matched by NAME (``PADDLE_CHAOS_WEIGHT_AT``):
    publish | stream | wt:<seq> | commit | swap | finalize — the
    ``wt:<seq>`` form targets the send of one streamed weight frame, so
    a soak can kill mid-stream with some leaves already staged.
    ``PADDLE_CHAOS_WEIGHT_SKIP`` skips the first n matches so a later
    epoch's flip takes the fault.

    kill    — SIGKILL at the matching fence; the relaunched coordinator
              must recover exactly-once epoch flips from the journal.
    latency — sleep PADDLE_CHAOS_WEIGHT_LATENCY_MS at the matching
              fence, widening the mixed-epoch serving window.
    """
    global _weight_fence_hits
    if not armed():
        return
    mode = _env("PADDLE_CHAOS_WEIGHT_MODE")
    if mode is None:
        return
    if _env("PADDLE_CHAOS_WEIGHT_AT") != fence:
        return
    skip = int(_env("PADDLE_CHAOS_WEIGHT_SKIP", "0"))
    _weight_fence_hits += 1
    if _weight_fence_hits <= skip:
        return
    if mode == "kill":
        _fault("weight_kill", fence=fence, hit=_weight_fence_hits)
        _sigkill(f"kill injected at online weight fence {fence!r}")
    elif mode == "latency":
        ms = float(_env("PADDLE_CHAOS_WEIGHT_LATENCY_MS", "0"))
        _fault("weight_latency", fence=fence, ms=ms)
        if ms > 0:
            time.sleep(ms / 1000.0)


# ---------------------------------------------------------------------------
# Serving-engine faults (called by serving/worker.py before each step)
# ---------------------------------------------------------------------------
def engine_fence(step: int) -> None:
    """Fault point before a serving worker's scheduler step. ``step``
    counts decode/verify steps executed by this worker's engine, so
    PADDLE_CHAOS_ENGINE_AT can target "mid-decode" precisely: requests
    admitted, KV pages held, tokens half-emitted — the window the router's
    failover must drain without losing or duplicating a request.

    kill    — SIGKILL at the matching step; the router must detect the
              stale occupancy beat and resubmit the engine's in-flight
              requests to a live engine (bit-equal reruns: request seeds
              are explicit).
    latency — sleep PADDLE_CHAOS_ENGINE_LATENCY_MS at the matching step,
              exercising the router's staleness grace without a death.
    """
    if not armed():
        return
    mode = _env("PADDLE_CHAOS_ENGINE_MODE")
    if mode is None:
        return
    at = int(_env("PADDLE_CHAOS_ENGINE_AT", "0"))
    if step != at:
        return
    if mode == "kill":
        _fault("engine_kill", step=step)
        _sigkill(f"kill injected at serving decode step {step}")
    elif mode == "latency":
        ms = float(_env("PADDLE_CHAOS_ENGINE_LATENCY_MS", "0"))
        _fault("engine_latency", step=step, ms=ms)
        if ms > 0:
            time.sleep(ms / 1000.0)


# ---------------------------------------------------------------------------
# Streaming-transport faults (called by serving/transport.py per frame send)
# ---------------------------------------------------------------------------
def net_fence(index: int) -> Optional[str]:
    """Fault point before a streaming-transport frame send. ``index``
    counts frame sends in this process, so PADDLE_CHAOS_NET_AT can target
    "the Nth frame" precisely — mid-dispatch, mid-KV-stream, or between a
    done record and the occupancy beat that acks it (the done-before-ack
    window the store ground truth must cover).

    Returns the action the transport must take: ``"drop"`` (sever the
    connection; the frame is lost and the sender reconnects with jittered
    backoff) or ``"half_open"`` (swallow the frame, report success — the
    silent half-open-socket fault). ``latency`` sleeps here and returns
    None (send proceeds), exercising the transport deadline guards.
    """
    if not armed():
        return None
    mode = _env("PADDLE_CHAOS_NET_MODE")
    if mode is None:
        return None
    at = int(_env("PADDLE_CHAOS_NET_AT", "0"))
    if index != at:
        return None
    if mode == "drop":
        _fault("net_drop", index=index)
        _log(f"net drop injected at transport frame {index}")
        return "drop"
    if mode == "half_open":
        _fault("net_half_open", index=index)
        _log(f"net half_open injected at transport frame {index}")
        return "half_open"
    if mode == "latency":
        ms = float(_env("PADDLE_CHAOS_NET_LATENCY_MS", "0"))
        _fault("net_latency", index=index, ms=ms)
        if ms > 0:
            time.sleep(ms / 1000.0)
    return None


# ---------------------------------------------------------------------------
# Checkpoint-commit faults (called by the atomic writer)
# ---------------------------------------------------------------------------
def _ckpt_mode_for(final_path: str) -> Optional[str]:
    if not armed():
        return None
    mode = _env("PADDLE_CHAOS_CKPT_MODE")
    if mode is None:
        return None
    want = _env("PADDLE_CHAOS_CKPT_STEP")
    if want is not None:
        tail = os.path.basename(os.path.normpath(final_path)).rsplit("_", 1)[-1]
        if not (tail.isdigit() and int(tail) == int(want)):
            return None
    return mode


def on_commit(tmp_path: str, final_path: str) -> None:
    """Fault point BETWEEN the checkpoint body write and its commit
    (manifest + atomic rename) — the window a real kill -9 tears."""
    mode = _ckpt_mode_for(final_path)
    if mode == "crash":
        _fault("ckpt_crash", path=final_path)
        _sigkill(f"crash injected before commit of {final_path}")
    elif mode == "torn":
        # what the legacy non-atomic writer left behind: the final name
        # exists, no commit record, one file cut short
        if os.path.exists(final_path):
            shutil.rmtree(final_path)
        os.replace(tmp_path, final_path)
        truncate_one_file(final_path)
        _fault("ckpt_torn", path=final_path)
        _sigkill(f"torn write injected at {final_path}")


def after_commit(final_path: str) -> None:
    """Fault point after a successful commit: silent byte corruption."""
    if _ckpt_mode_for(final_path) == "corrupt":
        corrupt_checkpoint(final_path)
        _fault("ckpt_corrupt", path=final_path)
        _log(f"corrupted one shard under {final_path}")


# ---------------------------------------------------------------------------
# Store faults (called by runtime/py_store.py)
# ---------------------------------------------------------------------------
def store_faults_enabled() -> bool:
    return enabled() and (
        _env("PADDLE_CHAOS_STORE_DROP") is not None
        or _env("PADDLE_CHAOS_STORE_LATENCY_MS") is not None
    )


def store_latency() -> None:
    ms = float(_env("PADDLE_CHAOS_STORE_LATENCY_MS", "0"))
    if ms > 0 and armed():
        time.sleep(ms / 1000.0)


def store_should_drop() -> bool:
    """Deterministically decide whether to sever the client connection
    before this store op (the retry path must survive and re-issue)."""
    p = float(_env("PADDLE_CHAOS_STORE_DROP", "0"))
    drop = p > 0 and armed() and rng().random() < p
    if drop:
        _fault("store_drop")
    return drop


# ---------------------------------------------------------------------------
# Damage helpers — usable directly from tests, no env required
# ---------------------------------------------------------------------------
def _data_files(root: str) -> List[Tuple[int, str]]:
    """(size, path) for every regular file under a checkpoint dir except
    the commit manifest, largest first (deterministic tiebreak on path)."""
    from ..distributed.checkpoint.manifest import MANIFEST_NAME

    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if dirpath == root and fn == MANIFEST_NAME:
                continue
            full = os.path.join(dirpath, fn)
            out.append((os.path.getsize(full), full))
    out.sort(key=lambda t: (-t[0], t[1]))
    return out


def truncate_one_file(root: str) -> Optional[str]:
    """Cut the largest data file in half (a torn write)."""
    files = _data_files(root)
    if not files:
        return None
    size, path = files[0]
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return path


def corrupt_checkpoint(root: str, nbytes: int = 8) -> Optional[str]:
    """Flip `nbytes` bytes in the middle of the largest data file, leaving
    sizes (and the manifest) intact — only a checksum catches this."""
    files = _data_files(root)
    if not files:
        return None
    size, path = files[0]
    off = max(0, size // 2 - nbytes)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(nbytes)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


def tear_checkpoint(root: str) -> None:
    """Make a committed checkpoint look like a mid-save kill under the
    legacy writer: commit record gone, largest file truncated."""
    from ..distributed.checkpoint.manifest import manifest_path

    try:
        os.remove(manifest_path(root))
    except OSError:
        pass
    truncate_one_file(root)
