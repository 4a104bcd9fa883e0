"""Heartbeat watchdog for the multi-process path (counterpart of
``paddle_tpu/runtime/watchdog.py``).

A hung rank (a deadlocked collective, a wedged host loop, a stuck input
pipeline) is worse than a dead one: the job holds its cards forever with
no error. Every rank runs a BEAT thread that bumps a per-rank counter in a
coordination store; the monitor rank (rank 0 by default) runs a MONITOR
thread that tracks when each peer's counter last changed and, once a peer
has been silent past the miss budget, ends the job with a diagnosis naming
the stalled rank(s): a silent hang becomes a crash the launcher's
relaunch and ``fleet.elastic`` recover from.

Env knobs (exported by ``python -m paddle_tpu_torch.distributed.launch
--heartbeat_interval`` and read by :func:`maybe_start_from_env`, which
``distributed.init_parallel_env`` calls right after the process group is
up):

  PADDLE_HEARTBEAT_INTERVAL   seconds between beats (0 / unset: disabled)
  PADDLE_HEARTBEAT_MISS       beats a peer may miss before it is declared
                              stalled (default 5; grace = interval * miss)

The heartbeat store is a ``runtime.TCPStore`` on the master's port + 2
(the process group's store holds the port, the launcher's rank
negotiation port + 1), hosted by rank 0.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from .. import observability as _obs

__all__ = ["HeartbeatWatchdog", "maybe_start_from_env", "stop_active",
           "active"]


#: the beat value of a rank that stopped on purpose
_LEFT = b"left"


def _default_on_stall(stalled: Dict[int, float], grace: float) -> None:
    names = ", ".join(f"rank {r} (silent {age:.0f}s)"
                      for r, age in sorted(stalled.items()))
    print(
        f"[watchdog] FATAL: {names} missed the heartbeat budget "
        f"({grace:.0f}s): the worker is hung (deadlocked collective or "
        "wedged host loop), not dead. Failing the job so the supervisor "
        "can relaunch from the last checkpoint.",
        file=sys.stderr, flush=True)
    # os._exit, not sys.exit: the monitor must take the process down even
    # when the main thread is the one that is wedged
    os._exit(124)


class HeartbeatWatchdog:
    """Store-backed liveness monitor.

    Every participant calls ``start()``; the ``monitor_rank`` also watches
    every peer. ``stop()`` (or process exit: the threads are daemons) ends
    participation. The store must outlive the watchdog."""

    def __init__(self, store, rank: int, world_size: int,
                 interval: float = 5.0, miss: int = 5,
                 label: str = "default", monitor_rank: int = 0,
                 on_stall: Optional[Callable[[Dict[int, float], float],
                                             None]] = None):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.interval = float(interval)
        self.miss = max(1, int(miss))
        self.label = label
        self.monitor_rank = int(monitor_rank)
        self.on_stall = on_stall or _default_on_stall
        self._stop = threading.Event()
        self._threads = []
        self._beats = 0
        #: the peers the monitor declared stalled (empty while all beat)
        self.stalled: Dict[int, float] = {}

    @property
    def beats(self) -> int:
        return self._beats

    # -- wire format --------------------------------------------------------
    def _key(self, rank: int) -> str:
        return f"__hb/{self.label}/{rank}"

    # -- beat side ----------------------------------------------------------
    def _beat_loop(self):
        last_beat = time.monotonic()
        while not self._stop.is_set():
            self._beats += 1
            try:
                self.store.set(self._key(self.rank), str(self._beats))
            except (ConnectionError, OSError, TimeoutError):
                # the store went with the master: the job is coming down
                # anyway, no watchdog crash on top
                return
            now = time.monotonic()
            # every rank exports its own liveness (the monitor sees only
            # its PEERS, and runs on one rank)
            _obs.inc("heartbeat_beats_total")
            _obs.set_gauge("heartbeat_age_seconds", now - last_beat,
                           rank=self.rank)
            _obs.observe("watchdog_poll_age_seconds", now - last_beat,
                         rank=self.rank)
            _obs.flush()
            last_beat = now
            self._stop.wait(self.interval)

    # -- monitor side -------------------------------------------------------
    def _read_peer(self, rank: int) -> Optional[bytes]:
        try:
            if not self.store.check(self._key(rank)):
                return None
            return self.store.get(self._key(rank), timeout=self.interval)
        except (ConnectionError, OSError, TimeoutError):
            return None

    def _monitor_loop(self):
        grace = self.interval * self.miss
        last_value: Dict[int, Optional[bytes]] = {}
        last_change: Dict[int, float] = {}
        now = time.monotonic()
        for r in range(self.world_size):
            if r != self.rank:
                last_value[r] = None
                last_change[r] = now  # start-up grace: the clock starts now
        while not self._stop.is_set():
            self._stop.wait(self.interval)
            if self._stop.is_set():
                return
            now = time.monotonic()
            stalled: Dict[int, float] = {}
            for r in list(last_value):
                v = self._read_peer(r)
                if v == _LEFT:  # the peer stopped on purpose
                    del last_value[r], last_change[r]
                    continue
                if v is not None and v != last_value[r]:
                    last_value[r] = v
                    last_change[r] = now
                elif now - last_change[r] > grace:
                    stalled[r] = now - last_change[r]
                age = now - last_change[r]
                _obs.set_gauge("heartbeat_age_seconds", age, rank=r)
                _obs.observe("watchdog_poll_age_seconds", age, rank=r)
            if stalled:
                # the diagnosis and a final export BEFORE on_stall: the
                # default handler os._exit()s, which skips atexit hooks
                self.stalled = dict(stalled)
                _obs.event("rank_stalled",
                           stalled={str(r): round(a, 3)
                                    for r, a in stalled.items()},
                           grace=grace, monitor_rank=self.rank)
                _obs.flush()
                self.on_stall(stalled, grace)
                return

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "HeartbeatWatchdog":
        _obs.event("watchdog_start", interval=self.interval, miss=self.miss,
                   world_size=self.world_size, label=self.label,
                   monitor=(self.rank == self.monitor_rank))
        t = threading.Thread(target=self._beat_loop, daemon=True,
                             name=f"hb-beat-{self.label}")
        t.start()
        self._threads.append(t)
        if self.rank == self.monitor_rank and self.world_size > 1:
            m = threading.Thread(target=self._monitor_loop, daemon=True,
                                 name=f"hb-monitor-{self.label}")
            m.start()
            self._threads.append(m)
        return self

    def stop(self):
        """End participation: the threads stop, and the beat key says the
        rank left on purpose, so a monitor that outlives it (rank 0 still
        writing a checkpoint) does not take it for a hang."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2 * self.interval)
        self._threads = []
        try:
            self.store.set(self._key(self.rank), _LEFT)
        except (ConnectionError, OSError, TimeoutError):
            pass


_active: Optional[HeartbeatWatchdog] = None


def active() -> Optional[HeartbeatWatchdog]:
    """The watchdog :func:`maybe_start_from_env` started, or None."""
    return _active


def maybe_start_from_env() -> Optional[HeartbeatWatchdog]:
    """Start the watchdog when the launch CLI asked for one
    (PADDLE_HEARTBEAT_INTERVAL > 0, world size > 1, PADDLE_MASTER set).
    The heartbeat store lives on the master's port + 2; rank 0 hosts it,
    everyone connects. Safe to call more than once."""
    global _active
    if _active is not None:
        return _active
    try:
        interval = float(os.environ.get("PADDLE_HEARTBEAT_INTERVAL", "0"))
    except ValueError:
        return None
    if interval <= 0:
        return None
    master = os.environ.get("PADDLE_MASTER", "")
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if "://" in master:  # an init URL: only tcp:// names a host and port
        if not master.startswith("tcp://"):
            return None
        master = master[len("tcp://"):]
    if not master or world_size < 2:
        return None
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    miss = int(os.environ.get("PADDLE_HEARTBEAT_MISS", "5"))
    host, port = master.rsplit(":", 1)
    from . import TCPStore

    store = TCPStore(host, int(port) + 2, is_master=(rank == 0),
                     timeout=max(60.0, interval * miss))
    _active = HeartbeatWatchdog(store, rank, world_size,
                                interval=interval, miss=miss,
                                label="spmd").start()
    return _active


def stop_active():
    global _active
    if _active is not None:
        _active.stop()
        try:
            _active.store.close()
        except Exception:
            pass
        _active = None
