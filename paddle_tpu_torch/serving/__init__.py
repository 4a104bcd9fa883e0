"""Multi-engine serving: paged-KV decode engines behind an SLO-aware
request router, on a streaming dataplane (counterpart of
``paddle_tpu/serving``).

- Each worker (``worker.EngineWorker``) wraps one ``inference.DecodeEngine``
  (K3 on the card), registers through the coordination store
  (``runtime.TCPStore``; ``protocol`` key schema) and serves its hot path
  over a persistent transport socket. Workers take a role: ``unified``,
  ``prefill`` (export KV pages and stream them to decode workers) or
  ``decode`` (import streamed prefills).
- ``transport`` is the dataplane: length-prefixed frames over plain TCP
  carrying dispatches, completion acks, occupancy heartbeats and KV-page
  streams, with jittered-backoff reconnects. The store stays the
  membership / failover ground truth.
- The ``Router`` admits requests against a bounded queue with SLO
  classes, places them by least-outstanding-tokens with prefix affinity —
  long prompts go to a prefill worker and stream KV to their decode
  worker — and fails over dead engines by resubmitting their unfinished
  work, bit-equal because every request carries a router-assigned seed.
- ``online`` publishes versioned weight epochs into live engines as
  journaled, seq-acked ``wt`` streams that flip at a request boundary,
  with no drain (``OnlineCoordinator``, ``EngineSink``,
  ``WireEngineSink``, ``rollout_round``).

Not ported yet (ROADMAP.md §A.4b, §A.8): the ``FrontierRouter`` front
tier (``frontier.py``) and the replay generator (``replay.py``); the
front tier's names below raise ``NotImplementedError``.
"""
from .protocol import (DEFAULT_DEADLINES, DEFAULT_NAMESPACE, ROLES,
                       SLO_CLASSES, SLO_OBJECTIVES, deadline_guard)
from .online import (EngineSink, OnlineCoordinator, WireEngineSink,
                     rollout_round)
from .router import Router, RouterConfig, RouterRequest
from .transport import SeqChannels, TransportClient, TransportServer
from .worker import EngineWorker

__all__ = [
    "Router", "RouterConfig", "RouterRequest", "EngineWorker",
    "TransportClient", "TransportServer", "SeqChannels",
    "OnlineCoordinator", "EngineSink", "WireEngineSink", "rollout_round",
    "SLO_CLASSES", "SLO_OBJECTIVES", "DEFAULT_DEADLINES",
    "DEFAULT_NAMESPACE", "ROLES", "deadline_guard",
]

_UNPORTED = {
    "FrontierRouter": "frontier.py", "FrontierConfig": "frontier.py",
    "rendezvous_rank": "frontier.py",
}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.serving.{name} ({_UNPORTED[name]}) is not "
            "ported yet, see ROADMAP.md §A.8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
