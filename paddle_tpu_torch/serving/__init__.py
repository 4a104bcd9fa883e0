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
- Above the routers, the ``FrontierRouter`` (``frontier``) federates
  several leaf routers: tenants shard onto leaves by sticky rendezvous
  hashing, per-tenant token-bucket quotas shed abusive traffic before it
  can burn a class error budget, and hot tenants spread across their
  top-ranked leaves. ``replay`` is the matching workload generator:
  deterministic arrival streams against real leaves or in-process stub
  fleets on a virtual clock.
- ``online`` publishes versioned weight epochs into live engines as
  journaled, seq-acked ``wt`` streams that flip at a request boundary,
  with no drain (``OnlineCoordinator``, ``EngineSink``,
  ``WireEngineSink``, ``rollout_round``).
"""
from .protocol import (DEFAULT_DEADLINES, DEFAULT_NAMESPACE, ROLES,
                       SLO_CLASSES, SLO_OBJECTIVES, deadline_guard)
from .frontier import FrontierConfig, FrontierRouter, rendezvous_rank
from .online import (EngineSink, OnlineCoordinator, WireEngineSink,
                     rollout_round)
from .router import Router, RouterConfig, RouterRequest
from .transport import SeqChannels, TransportClient, TransportServer
from .worker import EngineWorker

__all__ = [
    "Router", "RouterConfig", "RouterRequest", "EngineWorker",
    "FrontierRouter", "FrontierConfig", "rendezvous_rank",
    "TransportClient", "TransportServer", "SeqChannels",
    "OnlineCoordinator", "EngineSink", "WireEngineSink", "rollout_round",
    "SLO_CLASSES", "SLO_OBJECTIVES", "DEFAULT_DEADLINES",
    "DEFAULT_NAMESPACE", "ROLES", "deadline_guard",
]
