"""Per-tenant cost accounting: the metering ledger behind capacity
attribution (counterpart of ``paddle_tpu/observability/accounting.py``,
the same arithmetic).

Every request carries an optional ``tenant`` label (protocol.py request
records; absent tenant costs zero wire bytes and lands on the ``"-"``
default).  The serving plane meters each request's resource consumption
into a :class:`TenantLedger` keyed by ``(tenant, slo_class)``:

========================  ====================================================
field                     meaning
========================  ====================================================
``requests``              completed requests (counted once, on the engine
                          where the request finishes)
``shed_requests``         requests shed by the router admission ladder
``prefill_tokens``        prompt tokens prefilled (full prompt length;
                          prefix-cache hits still count — the pages exist)
``decode_tokens``         generated tokens (prefill's first token included,
                          counted exactly once across disaggregated engines)
``spec_accepted_tokens``  draft tokens accepted by speculative verify
``spec_wasted_tokens``    draft tokens proposed but rejected (wasted work)
``kv_page_us``            time-integrated KV page occupancy in page-
                          **microseconds** (integer fixed point, so pro-rata
                          splits of shared-prefix pages conserve exactly)
``wire_bytes``            logit-recombination + KV-stream wire bytes
``queue_seconds``         admission-queue wait (submit -> prefill start)
========================  ====================================================

All conservation-gated fields are integers: **the per-tenant sums equal
the untagged fleet totals exactly** (``fleet()`` is the deterministic sum
over cells; the bench cross-checks the token fields against the engines'
untagged counters as exact ints).  ``device_seconds`` is a *derived*
linear normalization via :class:`Prices` (the planner's calibrated cost
constants).

Bounded memory everywhere: ledgers fold overflow tenants into the ``"~"``
cell past ``max_cells``; the aggregator tracks heavy hitters with a
:class:`SpaceSavingSketch` (Metwally et al. space-saving: ``count`` is an
overestimate of the true total by at most ``error``; any tenant whose
true total exceeds ``fleet_total / capacity`` is guaranteed tracked).

stdlib-only at import time (loadable by file path, like tracing.py);
metric emission lazily binds the observability facade.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: the untagged default — requests with no tenant label
DEFAULT_TENANT = "-"
#: the fold-in cell for tenants evicted past a ledger's ``max_cells``
OVERFLOW_TENANT = "~"
#: slo key for fleet-level charges not attributable to one request
#: (registry-held shared-prefix pages, integer split remainders)
UNATTRIBUTED_SLO = "-"

#: conservation-gated integer fields, in canonical order
INT_FIELDS = (
    "requests", "shed_requests", "prefill_tokens", "decode_tokens",
    "spec_accepted_tokens", "spec_wasted_tokens", "kv_page_us",
    "wire_bytes",
)
#: advisory float fields (not in the exact-conservation gate)
FLOAT_FIELDS = ("queue_seconds",)
FIELDS = INT_FIELDS + FLOAT_FIELDS

_SEP = "|"  # (tenant, slo) -> wire key; normalize_tenant strips the sep


def enabled() -> bool:
    """Accounting rides the telemetry enablement (one env dict lookup
    when off — the µs-scale disabled-path contract).  The bench A/B
    forces it off under live telemetry with
    ``PADDLE_TPU_TENANT_ACCOUNTING=0``."""
    if not os.environ.get("PADDLE_TPU_TELEMETRY_DIR"):
        return False
    return os.environ.get("PADDLE_TPU_TENANT_ACCOUNTING", "1") != "0"


@functools.lru_cache(maxsize=4096)
def _normalize_label(label: str) -> str:
    t = label.strip()
    if not t:
        return DEFAULT_TENANT
    t = "".join(c if (c.isprintable() and c != _SEP and not c.isspace())
                else "_" for c in t)
    return t[:64] or DEFAULT_TENANT


def normalize_tenant(tenant) -> str:
    """Coerce a user-supplied tenant label into the ledger alphabet:
    non-empty printable string without the wire separator, <= 64 chars.
    ``None``/empty -> the ``"-"`` default. Cached per label: the
    per-request call sites (router admission, frontier quota gate) see
    the same few labels millions of times in a replay."""
    if tenant is None:
        return DEFAULT_TENANT
    return _normalize_label(str(tenant))


# -- device-second normalization ---------------------------------------------


class Prices:
    """Linear per-unit prices converting ledger fields into normalized
    device-seconds — the same currency the auto-parallel planner prices
    layouts in, so later quota decisions compare like with like."""

    __slots__ = ("prefill_token_s", "decode_token_s", "wasted_token_s",
                 "page_second_s", "wire_byte_s", "source")

    def __init__(self, prefill_token_s: float = 4.0e-4,
                 decode_token_s: float = 4.0e-4,
                 wasted_token_s: float = 4.0e-4,
                 page_second_s: float = 1.31072e-3,
                 wire_byte_s: float = 1.0e-8,
                 source: str = "defaults"):
        self.prefill_token_s = float(prefill_token_s)
        self.decode_token_s = float(decode_token_s)
        self.wasted_token_s = float(wasted_token_s)
        self.page_second_s = float(page_second_s)
        self.wire_byte_s = float(wire_byte_s)
        self.source = source

    @classmethod
    def from_cost_constants(cls, cc, flops_per_token: float = 2.0e6,
                            page_bytes: float = 131072.0) -> "Prices":
        """Derive prices from a planner ``CostConstants`` (calibrated or
        analytic): a token costs its FLOPs, a page-second costs holding
        ``page_bytes`` of HBM for one second, a wire byte costs itself."""
        dflt = cls()
        per_tok = float(cc.sec_per_flop) * float(flops_per_token)
        per_page_s = float(cc.sec_per_byte) * float(page_bytes)
        per_byte = float(cc.sec_per_byte)
        # a calibration can legitimately zero an axis it never observed;
        # a zero *price* would hide that resource from attribution, so
        # floor each component at the analytic default instead
        if per_tok <= 0.0:
            per_tok = dflt.decode_token_s
        if per_page_s <= 0.0:
            per_page_s = dflt.page_second_s
        if per_byte <= 0.0:
            per_byte = dflt.wire_byte_s
        return cls(prefill_token_s=per_tok, decode_token_s=per_tok,
                   wasted_token_s=per_tok, page_second_s=per_page_s,
                   wire_byte_s=per_byte,
                   source=getattr(cc, "source", "cost_constants"))

    def device_seconds(self, cell: Dict[str, float]) -> float:
        """Price one ledger cell (or any field dict) in device-seconds."""
        return (
            cell.get("prefill_tokens", 0) * self.prefill_token_s
            + cell.get("decode_tokens", 0) * self.decode_token_s
            + cell.get("spec_wasted_tokens", 0) * self.wasted_token_s
            + cell.get("kv_page_us", 0) * 1e-6 * self.page_second_s
            + cell.get("wire_bytes", 0) * self.wire_byte_s
        )

    def to_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in self.__slots__}


def default_prices() -> Prices:
    """Prices from the planner's (calibrated on the card, else analytic)
    cost constants; the hardcoded fallback keeps this module
    stdlib-standalone."""
    try:
        from ..distributed.auto_parallel.planner import load_calibration

        return Prices.from_cost_constants(load_calibration())
    except Exception:  # noqa: BLE001 — pricing never gates metering
        return Prices()


# -- the ledger --------------------------------------------------------------


def _zero_cell() -> Dict[str, float]:
    c: Dict[str, float] = {f: 0 for f in INT_FIELDS}
    for f in FLOAT_FIELDS:
        c[f] = 0.0
    return c


class TenantLedger:
    """Cumulative (tenant, slo) -> usage cells plus a drainable delta for
    the live plane.  Single-threaded like the rest of the serving plane.

    Conservation by construction: ``fleet()`` sums the cells in sorted
    key order, so per-tenant sums equal the fleet total *by definition*;
    the independent checks compare the integer fields against the
    engines' untagged counters.  Memory is bounded: past ``max_cells``
    distinct keys, new tenants fold into the ``"~"`` overflow cell
    (their usage stays conserved, only the attribution coarsens)."""

    def __init__(self, max_cells: int = 512):
        self.max_cells = int(max_cells)
        self._cells: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._delta: Dict[Tuple[str, str], Dict[str, float]] = {}
        self.folded_tenants = 0  # distinct tenants folded into "~"

    # fast-path guard used by call sites: `if led is not None: led.add(...)`

    def _cell_key(self, tenant: str, slo: str) -> Tuple[str, str]:
        key = (tenant, slo)
        if key in self._cells or len(self._cells) < self.max_cells:
            return key
        self.folded_tenants += 1
        return (OVERFLOW_TENANT, slo)

    def add(self, tenant: str, slo: str, **fields) -> None:
        key = self._cell_key(tenant, slo)
        cum = self._cells.get(key)
        if cum is None:
            cum = self._cells[key] = _zero_cell()
        dlt = self._delta.get(key)
        if dlt is None:
            dlt = self._delta[key] = {}
        for f, v in fields.items():
            cum[f] += v
            dlt[f] = dlt.get(f, 0) + v

    # -- views ---------------------------------------------------------------

    def cells(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        return {k: dict(v) for k, v in self._cells.items()}

    def fleet(self) -> Dict[str, float]:
        """Untagged fleet totals: the deterministic (sorted-key) sum over
        every cell.  Integer fields conserve exactly."""
        tot = _zero_cell()
        for key in sorted(self._cells):
            cell = self._cells[key]
            for f in FIELDS:
                tot[f] += cell.get(f, 0)
        return tot

    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        """Cells collapsed over slo class, keyed by tenant (sorted sum —
        same conservation property as :meth:`fleet`)."""
        out: Dict[str, Dict[str, float]] = {}
        for (tenant, _slo) in sorted(self._cells):
            acc = out.setdefault(tenant, _zero_cell())
            cell = self._cells[(tenant, _slo)]
            for f in FIELDS:
                acc[f] += cell.get(f, 0)
        return out

    def __len__(self) -> int:
        return len(self._cells)

    # -- wire ----------------------------------------------------------------

    def collect_delta(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Drain accumulated deltas as a JSON-safe dict (``"tenant|slo"``
        -> field deltas), or None when nothing changed.  Rides the
        LiveShipper payload under its ``(src, seq)`` exactly-once dedup —
        no second instrumentation path."""
        if not self._delta:
            return None
        out = {f"{t}{_SEP}{s}": dict(v)
               for (t, s), v in self._delta.items() if v}
        self._delta = {}
        return out or None

    def snapshot_wire(self) -> Dict[str, Dict[str, float]]:
        """Full cumulative cells in wire form (post-hoc reconcile)."""
        return {f"{t}{_SEP}{s}": dict(v)
                for (t, s), v in self._cells.items()}

    def merge_wire(self, wire: Dict[str, Dict[str, float]]) -> None:
        """Fold a :meth:`collect_delta` payload into this ledger (the
        aggregator side; idempotence comes from the shipper seq dedup)."""
        if not wire:
            return
        for key, fields in wire.items():
            tenant, _, slo = key.partition(_SEP)
            self.add(tenant or DEFAULT_TENANT, slo or UNATTRIBUTED_SLO,
                     **{f: v for f, v in fields.items() if f in FIELDS})


# -- page-second metering ----------------------------------------------------


class PageSecondsMeter:
    """Time-integrated KV page occupancy, attributed pro rata across
    refholders.  Ticked at engine step boundaries and at request
    detach/finish: the interval since the last tick is charged to the
    then-running set — a page with refcount ``r`` charges each holding
    request ``dt/r`` (shared-prefix pages split pro rata), and whatever
    the running set does not cover (registry-held shared pages, integer
    remainders) lands on the ``("-", "-")`` unattributed cell.

    Fixed-point integer page-microseconds make the split conserve
    *exactly*: per tick, the charges sum to ``round(dt*1e6) *
    pages_in_use`` as integers, always."""

    def __init__(self, ledger: TenantLedger):
        self.ledger = ledger
        self._last: Optional[float] = None
        self.total_page_us = 0  # independent untagged integral (cross-check)

    def tick(self, now: float, running: Iterable,
             refcount: Callable[[int], int], pages_in_use: int) -> None:
        """``running``: objects with ``.tenant``, ``.slo``, ``.page_ids``
        (and an ``acct_page_us`` accumulator, grown here so the
        per-request done event can carry its page integral)."""
        last, self._last = self._last, now
        if last is None:
            return
        dt_us = int(round((now - last) * 1e6))
        if dt_us <= 0 or pages_in_use <= 0:
            return
        total = dt_us * pages_in_use
        self.total_page_us += total
        accounted = 0
        for req in running:
            share = 0
            for pg in set(req.page_ids):
                rc = refcount(pg)
                if rc > 0:
                    share += dt_us // rc
            if share:
                accounted += share
                req.acct_page_us += share
                self.ledger.add(req.tenant, req.slo, kv_page_us=share)
        rem = total - accounted
        if rem > 0:
            self.ledger.add(DEFAULT_TENANT, UNATTRIBUTED_SLO,
                            kv_page_us=rem)


# -- heavy-hitter sketch -----------------------------------------------------


class SpaceSavingSketch:
    """Space-saving top-K (Metwally et al. 2005) with weighted
    increments: at most ``capacity`` tracked keys; an untracked arrival
    evicts the minimum-count key and inherits its count as ``error``.
    Guarantees: ``true <= count <= true + error``, and every key whose
    true total exceeds ``total/capacity`` is tracked.  Mergeable across
    aggregator windows (counts and error bounds add)."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        #: key -> [count, error]
        self._entries: Dict[str, List[float]] = {}
        self.total = 0.0  # sum of all offered increments

    def offer(self, key: str, inc: float = 1.0,
              error: float = 0.0) -> None:
        if inc <= 0 and error <= 0:
            return
        self.total += inc
        ent = self._entries.get(key)
        if ent is not None:
            ent[0] += inc
            ent[1] += error
            return
        if len(self._entries) < self.capacity:
            self._entries[key] = [inc, error]
            return
        # evict the minimum-count entry; the newcomer inherits its count
        # as an upper error bound (ties broken deterministically by key)
        victim = min(self._entries, key=lambda k: (self._entries[k][0], k))
        floor = self._entries.pop(victim)[0]
        self._entries[key] = [floor + inc, floor + error]

    def topk(self, k: Optional[int] = None
             ) -> List[Tuple[str, float, float]]:
        """[(key, count, error)] by descending count (key tiebreak)."""
        rows = sorted(self._entries.items(),
                      key=lambda kv: (-kv[1][0], kv[0]))
        if k is not None:
            rows = rows[:k]
        return [(key, ent[0], ent[1]) for key, ent in rows]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def merge(self, other: "SpaceSavingSketch") -> "SpaceSavingSketch":
        """Merged sketch over the union stream (mergeable-summaries
        style): common keys add counts and errors; a key missing from
        one side is bounded by that side's minimum count, which joins
        its error term."""
        cap = max(self.capacity, other.capacity)
        out = SpaceSavingSketch(cap)
        floors = []
        for sk in (self, other):
            ents = sk._entries
            full = len(ents) >= sk.capacity
            floors.append(min((e[0] for e in ents.values()), default=0.0)
                          if full else 0.0)
        keys = set(self._entries) | set(other._entries)
        for key in sorted(keys):
            count = err = 0.0
            for sk, floor in ((self, floors[0]), (other, floors[1])):
                ent = sk._entries.get(key)
                if ent is not None:
                    count += ent[0]
                    err += ent[1]
                else:
                    count += floor
                    err += floor
            out.offer(key, count, error=err)
        out.total = self.total + other.total
        return out


# -- metric / event emission -------------------------------------------------
#
# Single writer for the `tenant_*` metric family: every literal tenant_*
# metric name in the port lives in this module.  The facade import is lazy so the module stays
# stdlib-standalone for post-hoc tooling.


def _facade():
    try:
        from .. import observability as _obs
        return _obs if _obs.enabled() else None
    except Exception:  # noqa: BLE001 — emission never gates metering
        return None


def publish_tenant_gauges(ledger: TenantLedger,
                          prices: Optional[Prices] = None) -> None:
    """Set the per-tenant usage gauges from a ledger's cumulative totals
    (gauges, not counters: republishing cumulative values is idempotent,
    so local registry dumps never double-count)."""
    _obs = _facade()
    if _obs is None or ledger is None:
        return
    prices = prices or default_prices()
    for tenant, cell in ledger.per_tenant().items():
        _obs.set_gauge("tenant_device_seconds",
                       prices.device_seconds(cell), tenant=tenant)
        _obs.set_gauge("tenant_tokens", float(cell["prefill_tokens"]),
                       tenant=tenant, kind="prefill")
        _obs.set_gauge("tenant_tokens", float(cell["decode_tokens"]),
                       tenant=tenant, kind="decode")
        _obs.set_gauge("tenant_tokens",
                       float(cell["spec_accepted_tokens"]),
                       tenant=tenant, kind="spec_accepted")
        _obs.set_gauge("tenant_tokens", float(cell["spec_wasted_tokens"]),
                       tenant=tenant, kind="spec_wasted")
        _obs.set_gauge("tenant_kv_page_seconds",
                       cell["kv_page_us"] * 1e-6, tenant=tenant)
        _obs.set_gauge("tenant_wire_bytes", float(cell["wire_bytes"]),
                       tenant=tenant)
        _obs.set_gauge("tenant_shed_requests",
                       float(cell["shed_requests"]), tenant=tenant)


def publish_outstanding(per_engine: Dict[str, Dict[str, float]]) -> None:
    """Router-side per-engine per-tenant outstanding-token gauges — the
    raw signal the quota ladder (ROADMAP item 1) will gate on.  The
    router computes the dict; the set_gauge lives here (single writer)."""
    _obs = _facade()
    if _obs is None:
        return
    for engine, by_tenant in per_engine.items():
        for tenant, toks in by_tenant.items():
            _obs.set_gauge("tenant_outstanding_tokens", float(toks),
                           engine=engine, tenant=tenant)


def emit_heavy_hitter(tenant: str, device_seconds: float, rank: int,
                      share: float, window_s: float) -> None:
    """`tenant_heavy_hitter` event: a tenant surfaced in the
    aggregator's top-K (rank 0 = heaviest)."""
    _obs = _facade()
    if _obs is None:
        return
    _obs.event("tenant_heavy_hitter", tenant=tenant,
               device_seconds=float(device_seconds), rank=int(rank),
               share=float(share), window_s=float(window_s))


def emit_quota_throttled(tenant: str, slo: str, cost_tokens: int,
                         rate: float, burst: float) -> None:
    """`tenant_quota_throttled` event: the front tier shed a request
    because the tenant's token bucket ran dry.  The shed is attributed
    to the TENANT'S ledger row (shed_requests) and never reaches a leaf
    router, so it cannot burn the SLO class's error budget.  The event
    lives here — not in frontier.py — because the ``tenant_*`` telemetry
    family has a single writer."""
    _obs = _facade()
    if _obs is None:
        return
    _obs.event("tenant_quota_throttled", tenant=tenant, slo=slo,
               cost_tokens=int(cost_tokens), rate=float(rate),
               burst=float(burst))


def emit_reconcile(worst_rel_diff: float, tenants: int,
                   source: str) -> None:
    """`tenant_ledger_reconcile` event: live-ledger vs post-hoc
    attribution agreement ."""
    _obs = _facade()
    if _obs is None:
        return
    _obs.event("tenant_ledger_reconcile",
               worst_rel_diff=float(worst_rel_diff), tenants=int(tenants),
               source=source)
