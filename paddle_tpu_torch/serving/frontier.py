"""Federated front tier: shard tenants across leaf routers, enforce
per-tenant quotas, and aggregate the fleet view (counterpart of
``paddle_tpu/serving/frontier.py``).

One ``Router`` (serving/router.py) is a single pump loop: its dispatch
scan, store mirror and done harvest saturate long before the engines do.
The ``FrontierRouter`` scales the control plane out: it owns a set of
leaf routers (each with its own namespace and engine fleet) and places
every submission on exactly one leaf by **rendezvous
(highest-random-weight) hashing** of the tenant label. Rendezvous hashing
is sticky: a tenant keeps landing on the same leaf as leaves join and
leave, and only the tenants of a removed leaf move. That keeps two things
leaf-local: the prefix-affinity cache (a multi-turn tenant's prompts
re-hit the same leaf's paged prefix caches) and the per-tenant cost
ledger (no cross-leaf double counting). Untagged ("-") requests hash on
their first prompt page instead, so shared-prefix traffic without a
tenant label still lands on one leaf.

Quotas ride ABOVE the SLO shed ladder: each tenant has a token bucket
(``quota_rate_tokens_per_s`` + ``quota_burst_tokens``, with per-tenant
overrides) debited at admission by the request's token cost (prompt +
``max_new_tokens``). A request the bucket cannot cover is shed at the
FRONT TIER, charged to the tenant's ledger row (``shed_requests``) and
announced by the ``tenant_quota_throttled`` event; it never reaches a
leaf, so a quota shed cannot burn the class error budget the way a
queue_full / deadline shed inside the leaf does. Buckets key on the
NORMALIZED tenant label (``accounting.normalize_tenant``), the key the
ledger uses: a raw ``"  acme "`` or control-character label can neither
mint a second bucket nor drain the untagged "-" pool, and vice versa.

Hot tenants are the one case where stickiness loses: a tenant heavy
enough to saturate its home leaf should spread. The frontier reads the
heavy-hitter sketch (the SpaceSaving rows of ``fleet_health.json``'s
``tenants.top``: the shared live aggregator's when the live plane is on,
else its own submit-fed sketch), and a tenant whose share exceeds
``hot_tenant_share`` fans out over its top ``hot_tenant_spread``
rendezvous leaves, least-queued first. The spread set is still
rendezvous-ranked, so it is itself sticky.

Determinism: the frontier stamps every request's sampling seed from its
GLOBAL id (``seed * 1_000_003 + gid``) before the leaf sees it, so the
leaf's own rid-based stamping never runs and token streams are
bit-equal across topologies: one workload through one leaf or eight
yields the same tokens.

Telemetry: this module is the single writer of the ``frontier_*``
family. With the live plane on, the frontier creates ONE
``LiveAggregator``, hands it to every leaf
(``Router.share_live_aggregator``) so wire telemetry and ledger deltas
keep flowing, and drives the tick itself: the merged admission queues in
the supervisor-visible ``queues`` block plus the per-leaf breakdown in
the ``frontier`` block (``LiveAggregator.note_frontier``).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import observability as _obs
from ..observability import accounting as _acct
from ..observability import live as _live
from ..inference.engine import SamplingParams
from .protocol import SLO_CLASSES
from .router import Router, RouterRequest

__all__ = ["FrontierRouter", "FrontierConfig", "rendezvous_rank"]


def rendezvous_rank(key, leaf_names: Sequence[str],
                    seed: int = 0) -> List[str]:
    """Leaves ranked by highest-random-weight (rendezvous) hash for
    ``key`` (a tenant label or prompt-page bytes). Deterministic across
    processes and Python runs (blake2b, no PYTHONHASHSEED exposure);
    adding or removing a leaf only moves the keys that ranked it first.
    """
    if isinstance(key, str):
        key = key.encode("utf-8", "replace")
    salt = b"%d|" % seed + key + b"|"
    scored = []
    for name in leaf_names:
        h = hashlib.blake2b(salt + name.encode("utf-8", "replace"),
                            digest_size=8).digest()
        scored.append((int.from_bytes(h, "big"), name))
    scored.sort(reverse=True)
    return [name for _, name in scored]


@dataclass
class FrontierConfig:
    #: default per-tenant refill rate in tokens/second (0 = unlimited:
    #: no bucket is even created, the quota plane costs nothing)
    quota_rate_tokens_per_s: float = 0.0
    #: default bucket capacity in tokens (0 = 2s of rate)
    quota_burst_tokens: float = 0.0
    #: per-tenant (rate, burst) overrides; keys are normalized at
    #: construction so a raw label can never dodge its own quota
    tenant_quotas: Dict[str, Tuple[float, float]] = field(
        default_factory=dict)
    #: sketch share of priced usage past which a tenant is "hot" and
    #: may spread over several leaves
    hot_tenant_share: float = 0.25
    #: how many of its top rendezvous leaves a hot tenant fans out over
    hot_tenant_spread: int = 2
    #: seconds between heavy-hitter refreshes off the sketch
    rebalance_interval_s: float = 5.0
    #: base of the gid-derived sampling seeds (must match across
    #: topologies for bit-equal replays)
    seed: int = 0
    #: keep resolved request handles so ``status``/``result`` work after
    #: the fact; the replay harness turns this off (``on_resolve`` is
    #: the tap) to stay memory-bounded over millions of requests
    retain_results: bool = True


class _TokenBucket:
    """Classic token bucket in whatever clock the frontier runs on."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else 2.0 * float(rate)
        self.tokens = self.burst
        self.t = now

    def take(self, cost: float, now: float) -> bool:
        if now > self.t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t) * self.rate)
            self.t = now
        if cost <= self.tokens:
            self.tokens -= cost
            return True
        return False


class FrontierRouter:
    """Tenant-sharded front tier over a list of leaf ``Router``s.

    The leaves are constructed by the caller (each with its own
    namespace/store and — when determinism matters — the same injected
    clock as the frontier). Engine names must be distinct across leaves
    so merged gauges and the fleet view never alias.
    """

    def __init__(self, leaves: Sequence[Router],
                 config: Optional[FrontierConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 **overrides):
        if config is None:
            config = FrontierConfig(**overrides)
        elif overrides:
            raise ValueError("pass config= or field overrides, not both")
        if not leaves:
            raise ValueError("need at least one leaf router")
        names = [leaf.config.namespace for leaf in leaves]
        if len(set(names)) != len(names):
            raise ValueError(f"leaf namespaces must be distinct: {names}")
        self.config = config
        self._clock = clock
        self._leaves: Dict[str, Router] = dict(zip(names, leaves))
        self._names = names
        #: normalized per-tenant quota table (see FrontierConfig)
        self._quota_table = {
            _acct.normalize_tenant(t): (float(r), float(b))
            for t, (r, b) in config.tenant_quotas.items()}
        self._buckets: Dict[str, _TokenBucket] = {}
        self._next_gid = 0
        #: gid -> (leaf namespace, leaf rid) for placed requests
        self._placed: Dict[int, Tuple[str, int]] = {}
        #: per-leaf rid -> gid reverse maps for the on_resolve relay
        self._gids: Dict[str, Dict[int, int]] = {n: {} for n in names}
        #: resolutions that raced the gid mapping: a leaf can shed a
        #: request synchronously INSIDE submit (queue preemption), i.e.
        #: before the rid->gid row exists — the relay parks the record
        #: here and submit() re-fires it immediately after mapping
        self._orphans: Dict[str, Dict[int, RouterRequest]] = {
            n: {} for n in names}
        #: gid -> synthetic shed record for quota sheds (they never
        #: reach a leaf, so the frontier answers status/result itself)
        self._quota_shed: Dict[int, RouterRequest] = {}
        #: tenants currently allowed to spread (refreshed off the
        #: heavy-hitter sketch at rebalance_interval_s)
        self._hot: Dict[str, float] = {}
        self._last_rebalance = -float("inf")
        #: submit-fed fallback sketch: the rebalance signal when the
        #: live plane (and its priced sketch) is off
        self._sketch = _acct.SpaceSavingSketch(capacity=64)
        self._sketch_total = 0.0
        self.counters = {"submitted": 0, "placed": 0, "quota_shed": 0,
                         "rebalances": 0, "hot_spread_placements": 0}
        #: frontier-side ledger: quota sheds attributed per tenant
        self._acct: Optional[_acct.TenantLedger] = None
        #: shared live aggregator (created lazily; see module docstring)
        self._live_agg: Optional[_live.LiveAggregator] = None
        self.on_resolve: Optional[Callable[[int, RouterRequest], None]] \
            = None
        for name, leaf in self._leaves.items():
            leaf.on_resolve = self._make_resolve_relay(name)
        _obs.set_gauge("frontier_leaves", len(names))

    # -- clock ---------------------------------------------------------------

    def _now(self) -> float:
        return self._clock() if self._clock is not None \
            else time.perf_counter()

    # -- placement -----------------------------------------------------------

    def _hash_key(self, tenant: str, prompt: np.ndarray):
        """What rendezvous-hashes: the tenant label, or — for untagged
        traffic — the first prompt page, so shared-prefix request floods
        without a tenant still pin to one leaf's prefix caches."""
        if tenant != _acct.DEFAULT_TENANT:
            return tenant
        page = self._leaves[self._names[0]].config.page_size
        return prompt[:page].tobytes()

    def _pick_leaf(self, tenant: str, prompt: np.ndarray) -> str:
        ranked = rendezvous_rank(self._hash_key(tenant, prompt),
                                 self._names, self.config.seed)
        if tenant in self._hot and len(ranked) > 1:
            spread = ranked[:max(2, self.config.hot_tenant_spread)]
            name = min(spread,
                       key=lambda n: (self._leaves[n].queue_depth(),
                                      spread.index(n)))
            if name != ranked[0]:
                self.counters["hot_spread_placements"] += 1
            return name
        return ranked[0]

    # -- quota ---------------------------------------------------------------

    def _quota_for(self, tenant: str) -> Tuple[float, float]:
        if tenant in self._quota_table:
            return self._quota_table[tenant]
        return (self.config.quota_rate_tokens_per_s,
                self.config.quota_burst_tokens)

    def _quota_admit(self, tenant: str, cost: int, now: float) -> bool:
        """Debit the tenant's bucket; True = admit. Buckets key on the
        normalized label, so an untagged "-" request can only ever touch
        the "-" bucket."""
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate, burst = self._quota_for(tenant)
            if rate <= 0:
                return True  # unlimited: no bucket, no cost
            bucket = self._buckets[tenant] = _TokenBucket(rate, burst, now)
        return bucket.take(cost, now)

    # -- admission -----------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               slo: str = "standard", tenant: Optional[str] = None,
               **sampling) -> int:
        """Admit a request into the federated tier. Returns a global id
        usable with ``status``/``result`` regardless of which leaf (or
        the quota gate) handled it."""
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {slo!r}; expected one of {SLO_CLASSES}")
        if params is None:
            params = SamplingParams(**sampling)
        elif sampling:
            raise ValueError("pass params= or sampling kwargs, not both")
        if self._acct is None and _acct.enabled():
            self._acct = _acct.TenantLedger()
        tenant = _acct.normalize_tenant(tenant)
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        gid = self._next_gid
        self._next_gid += 1
        self.counters["submitted"] += 1
        _obs.inc("frontier_requests_total")
        now = self._now()
        cost = int(prompt.size) + int(params.max_new_tokens)
        self._sketch.offer(tenant, float(cost))
        self._sketch_total += float(cost)
        if not self._quota_admit(tenant, cost, now):
            return self._shed_quota(gid, tenant, slo, cost, now)
        if params.seed is None:
            # gid-derived seed, stamped HERE: the leaf sees an explicit
            # seed and never applies its own rid-based one, so token
            # streams are bit-equal across 1-leaf and N-leaf topologies
            params = replace(params, seed=self.config.seed * 1_000_003
                             + gid)
        name = self._pick_leaf(tenant, prompt)
        rid = self._leaves[name].submit(prompt, params=params, slo=slo,
                                        tenant=tenant)
        self._placed[gid] = (name, rid)
        self._gids[name][rid] = gid
        self.counters["placed"] += 1
        orphan = self._orphans[name].pop(rid, None)
        if orphan is not None:
            # the leaf resolved (shed) this rid synchronously during
            # submit, before the mapping above existed — deliver it now
            self._deliver(name, gid, orphan)
        return gid

    def _shed_quota(self, gid: int, tenant: str, slo: str, cost: int,
                    now: float) -> int:
        self.counters["quota_shed"] += 1
        rate, burst = self._quota_for(tenant)
        if self._acct is not None:
            # the TENANT wears the shed; no leaf ever saw the request,
            # so the class error budget cannot be charged for it
            self._acct.add(tenant, slo, shed_requests=1)
        _obs.inc("frontier_quota_shed_total")
        _acct.emit_quota_throttled(tenant, slo, cost, rate, burst)
        req = RouterRequest(rid=gid, prompt=np.empty(0, np.int64),
                            params=SamplingParams(), slo=slo,
                            submit_t=now, deadline_t=now, block_keys=[],
                            status="shed", tenant=tenant,
                            shed_reason="quota", finish_t=now)
        cb = self.on_resolve
        if cb is not None:
            cb(gid, req)
        if self.config.retain_results:
            self._quota_shed[gid] = req
        return gid

    def _deliver(self, name: str, gid: int, req: RouterRequest):
        cb = self.on_resolve
        if cb is not None:
            cb(gid, req)
        if not self.config.retain_results:
            self._gids[name].pop(req.rid, None)
            self._placed.pop(gid, None)

    def _make_resolve_relay(self, name: str):
        gids = self._gids[name]
        orphans = self._orphans[name]

        def relay(req: RouterRequest):
            gid = gids.get(req.rid)
            if gid is None:
                orphans[req.rid] = req  # resolved before mapping; see submit
                return
            self._deliver(name, gid, req)
        return relay

    # -- driving -------------------------------------------------------------

    def pump(self):
        """One federated round: pump every leaf, refresh the hot-tenant
        set at its cadence, then drive the shared live plane with the
        merged fleet view."""
        for leaf in self._leaves.values():
            leaf.pump()
        now = self._now()
        if now - self._last_rebalance >= self.config.rebalance_interval_s:
            self._last_rebalance = now
            self._refresh_hot_tenants()
        self._live_tick()
        _obs.set_gauge("frontier_queue_depth",
                       sum(leaf.queue_depth()
                           for leaf in self._leaves.values()))

    def _refresh_hot_tenants(self):
        """Re-derive the spread set from the heavy-hitter sketch: the
        live aggregator's priced rows when telemetry is on (the same
        rows fleet_health.json carries), else the frontier's own
        submit-fed token sketch."""
        if self._live_agg is not None:
            rows = self._live_agg.heavy_hitters(
                max(8, self.config.hot_tenant_spread))
        elif self._sketch_total > 0:
            rows = [(t, c / self._sketch_total)
                    for t, c, _ in self._sketch.topk(8)]
        else:
            rows = []
        hot = {t: share for t, share in rows
               if share >= self.config.hot_tenant_share
               and t != _acct.DEFAULT_TENANT}
        for tenant, share in hot.items():
            if tenant not in self._hot:
                self.counters["rebalances"] += 1
                _obs.inc("frontier_rebalance_total")
                _obs.event("frontier_hot_tenant_spread", tenant=tenant,
                           share=round(share, 6),
                           spread=self.config.hot_tenant_spread)
        self._hot = hot

    def note_hot_tenants(self, tenants: Sequence[str]):
        """Explicit override of the spread set (tests, replay scenarios,
        or a supervisor pushing policy): these tenants fan out starting
        with the next submission, sketch shares notwithstanding."""
        self._hot = {_acct.normalize_tenant(t): 1.0 for t in tenants}

    def _live_tick(self):
        if self._live_agg is None:
            if not _live.live_enabled():
                return
            self._live_agg = _live.LiveAggregator()
            for leaf in self._leaves.values():
                leaf.share_live_aggregator(self._live_agg)
        # supervisor-visible queues block: merged across leaves, same
        # schema a solo router writes — the SLO control loop
        # (serving/fleet.py) keeps consuming it unchanged
        admission = {c: 0 for c in SLO_CLASSES}
        outstanding: Dict[str, int] = {}
        merged_tenants: Dict[str, Dict[str, int]] = {}
        for leaf in self._leaves.values():
            for c, n in leaf.admission_depths().items():
                admission[c] += n
            for est in leaf._engines.values():
                if est.alive:
                    outstanding[est.name] = leaf._load_tokens(est)
            merged_tenants.update(leaf.tenant_outstanding())
        self._live_agg.note_queues({
            "admission": admission,
            "engine_outstanding_tokens": outstanding,
        })
        if merged_tenants:
            self._live_agg.note_tenants(None, merged_tenants)
        if self._acct is not None:
            self._live_agg.note_tenants(self._acct.collect_delta(), None)
        self._live_agg.note_frontier(self.fleet_view())
        self._live_agg.tick()

    def drain(self, timeout: Optional[float] = None,
              poll: float = 0.005) -> bool:
        """Pump until every leaf drains (done/failed/shed). True on full
        drain, False on (wall-clock) timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(leaf.pending() for leaf in self._leaves.values()):
            self.pump()
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll)
        return True

    def shutdown(self):
        for leaf in self._leaves.values():
            leaf.shutdown()

    # -- inspection ----------------------------------------------------------

    def status(self, gid: int) -> str:
        if gid in self._quota_shed:
            return "shed"
        name, rid = self._placed[gid]
        return self._leaves[name].status(rid)

    def result(self, gid: int) -> np.ndarray:
        req = self._quota_shed.get(gid)
        if req is not None:
            raise RuntimeError(
                f"request {gid} was shed (quota); tenant={req.tenant} "
                f"slo={req.slo}")
        name, rid = self._placed[gid]
        return self._leaves[name].result(rid)

    def leaf_of(self, gid: int) -> str:
        """Namespace of the leaf that owns ``gid`` (sticky-mapping
        tests); raises KeyError for quota sheds."""
        return self._placed[gid][0]

    def pending(self) -> int:
        return sum(leaf.pending() for leaf in self._leaves.values())

    def fleet_view(self) -> dict:
        """The merged per-leaf view the health doc's ``frontier`` block
        carries: queue depths and liveness per leaf, fleet admission
        totals, quota and hot-tenant state."""
        leaves = {}
        admission = {c: 0 for c in SLO_CLASSES}
        for name, leaf in self._leaves.items():
            depths = leaf.admission_depths()
            for c, n in depths.items():
                admission[c] += n
            leaves[name] = {
                "queue_depth": leaf.queue_depth(),
                "pending": leaf.pending(),
                "engines_alive": leaf._alive_count(),
                "admission": depths,
                "dispatched": leaf.counters["dispatched"],
                "shed": leaf.counters["shed"],
            }
        return {
            "leaves": leaves,
            "admission": admission,
            "queue_depth": sum(v["queue_depth"] for v in leaves.values()),
            "quota": {
                "tracked_buckets": len(self._buckets),
                "throttled_total": self.counters["quota_shed"],
            },
            "hot_tenants": sorted(self._hot),
        }

    def stats(self) -> dict:
        """Frontier counters + summed leaf counters + per-leaf stats."""
        per_leaf = {name: leaf.stats()
                    for name, leaf in self._leaves.items()}
        summed: Dict[str, int] = {}
        for st in per_leaf.values():
            for k, v in st.items():
                if isinstance(v, (int, float)):
                    summed[k] = summed.get(k, 0) + v
        return {**self.counters, "leaves": summed, "per_leaf": per_leaf}
