"""Cost-model auto-parallel planner (counterpart of
``paddle_tpu/distributed/auto_parallel/planner.py``: numpy and plain
Python, kept as the port's own copy): pick (dp, mp, pp, sharding,
schedule, virtual_pp_degree, grad-comm bucket) layouts analytically.

Following the Mesh-TensorFlow layout-cost formulation (arXiv:1811.02084)
and the weight-update sharding analysis of arXiv:2004.13336, this module
scores every divisibility-legal layout with a closed-form
alpha-beta-gamma model

    step ≈ x · compute  +  y · wire_bytes  +  z · collective_launches

whose constants are fitted to measured weak-scaling entries
(``calibrate``). The terms per candidate:

  * **compute** — 6·params·tokens FLOPs inflated by the analytic pipeline
    bubble of the candidate's schedule, the formulas of
    ``SpmdPipeline.schedule_info``: fill = (S−1)/V, fb_total = 3M + 3·fill
    (gpipe/1f1b) or 3M + max(0, 2·fill − M) (zero_bubble),
    bubble = 1 − 3M/fb_total.
  * **wire_bytes** — per-axis analytic collective payloads: mp activation
    all-reduces, ZeRO all-gather/reduce-scatter on the sharding axis, dp
    gradient all-reduce, pp boundary activations (× virtual chunks). Axes
    that cross the node boundary are charged at the NVLink / network
    bandwidth ratio (``Topology.dcn_penalty``).
  * **collective_launches** — per-step collective count; the latency /
    dispatch term that separates many-small from few-large layouts.

The port's calibration (``calibration_h100.json`` beside this file, read
by :func:`load_calibration`) holds weak-scaling entries measured on an
NVIDIA H100 by ``chip_smoke.py`` phase 53c: gloo ranks sharing the one
card, each layout the median of 5 steps. Those ranks serialize on the
card and the host, so the fitted constants are host-aggregate (cost terms
sum over ranks, not per rank), the regime the reference's one-host proxy
calibration also fits; the model form is the same on a machine with one
card a rank, only the constants change.

``plan(model_config, topology)`` enumerates legal meshes (degrees divide
the device count, mp divides heads and hidden, pp divides layers, the
batch splits over dp·sharding), prunes candidates whose analytic
params + optimizer-state + activation footprint (remat-granularity aware)
exceeds the per-device memory bound, ranks the rest, and returns a
``Plan``. ``apply_auto_plan`` merges the winner into a
``DistributedStrategy`` — **manual settings always win**: any knob the
user moved off its default is pinned and constrains the search instead of
being overwritten. Opt-in via ``DistributedStrategy.auto()`` or
``PADDLE_TPU_AUTO_PLAN=1``.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, asdict, replace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ... import observability as _obs

__all__ = [
    "ModelConfig", "Topology", "Candidate", "Plan", "CostConstants",
    "plan", "score", "calibrate", "load_calibration", "apply_auto_plan",
    "enumerate_candidates", "memory_bytes", "StagePlan", "MpmdPlan",
    "plan_mpmd_stages", "AttnKernelPlan", "plan_attn_kernel",
]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
@dataclass
class ModelConfig:
    """Workload shape for the cost model. The defaults are the
    calibration proxy's tiny GPT (the reference's, and ``chip_smoke.py``
    phase 53c's), so the calibration entries and the planner score the
    same model out of the box."""

    hidden: int = 64
    layers: int = 4
    heads: int = 4
    vocab: int = 256
    seq_len: int = 32
    global_batch: int = 16
    dtype_bytes: int = 4           # f32 master math on the proxy
    remat: str = "none"            # none | selective | full
    # assumed WIRE dtypes per collective family (f32 | bf16 | int8): what
    # actually crosses the mesh when grad_comm / mp_comm quantize the
    # exchange. Defaults are the exact f32 program, so the calibration
    # entries (measured unquantized) fit the same features as before;
    # ``apply_auto_plan`` fills them from the resolved strategy configs.
    mp_wire: str = "f32"           # mp activation recombination (mp_comm)
    grad_wire: str = "f32"         # dp grad exchange (grad_comm)
    zero_gather_wire: str = "f32"  # ZeRO param all-gather (mp_comm floor)

    @property
    def params(self) -> int:
        # transformer block ≈ 12·h² (qkv+proj 4h², mlp 8h²) + tied embed
        return 12 * self.layers * self.hidden ** 2 + self.vocab * self.hidden

    @property
    def tokens(self) -> int:
        return self.global_batch * self.seq_len

    @property
    def flops(self) -> float:
        # fwd+bwd ≈ 6 FLOPs per param per token (the PaLM rule of thumb)
        return 6.0 * self.params * self.tokens


@dataclass
class Topology:
    """Device fabric description. The defaults are one NVIDIA H100 SXM
    (NVIDIA H100 80GB HBM3, 700 W) in an 8-card NVLink node. The field
    names are the reference's TPU names, kept so the same keyword
    arguments build both packages' ``Topology``; on this card they mean:

    * ``ici_bw`` — NVLink 4, bytes/s per card per direction (900 GB/s
      both directions together: 4.5e11);
    * ``dcn_bw`` — the node's network per card, bytes/s (one 400 Gb/s
      NIC a card: 5.0e10); ``num_slices`` counts nodes;
    * ``peak_flops`` — bf16 dense on the tensor cores (989e12);
    * ``hbm_bytes`` / ``hbm_bw`` — HBM3 capacity (80e9) and bandwidth
      (3.35e12 B/s; decode is bound by it — prices the attention kernel
      choice).

    ``host_serialized`` marks the calibration regime (ranks sharing one
    card serialize through the host, costs sum instead of parallelize)
    — it is informational; the fitted constants already absorb it."""

    n_devices: int = 8
    num_slices: int = 1
    ici_bw: float = 4.5e11         # NVLink bytes/s per card, one direction
    dcn_bw: float = 5.0e10         # network bytes/s per card across nodes
    peak_flops: float = 989e12     # bf16 dense per card
    hbm_bytes: float = 80e9        # per card
    hbm_bw: float = 3.35e12        # HBM bytes/s per card
    host_serialized: bool = True

    @property
    def dcn_penalty(self) -> float:
        """NVLink-equivalent byte multiplier for node-crossing traffic."""
        return self.ici_bw / self.dcn_bw


@dataclass
class Candidate:
    dp: int = 1
    mp: int = 1
    pp: int = 1
    sharding: int = 1
    schedule: str = "gpipe"
    virtual_pp_degree: int = 1
    microbatches: int = 1
    bucket_mb: int = 32
    # filled by score()
    predicted_step_s: float = 0.0
    breakdown: Dict[str, float] = field(default_factory=dict)
    # the wire dtypes the byte model priced each axis at (ModelConfig)
    wire_dtypes: Dict[str, str] = field(default_factory=dict)

    @property
    def ndev(self) -> int:
        return self.dp * self.mp * self.pp * self.sharding

    def mesh_dict(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp, "pp": self.pp,
                "sharding": self.sharding}


#: the card the analytic fallback constants below are taken from
CARD = "NVIDIA H100 80GB HBM3, 700 W"


@dataclass
class CostConstants:
    """The calibrated cost constants (see module docstring).

    ``fixed_s`` is the per-step dispatch floor (host launch + program
    set-up); ``sec_per_dp_over_byte`` charges the data-parallel gradient
    exchange at (dp−1)·payload per device, the all-gather-style overcommit
    a host-staged exchange shows.

    The defaults are the analytic fallback when no calibration is found:
    one f32 FLOP at the card's f32 FMA peak (67e12 FLOP/s: the proxy
    trains in f32 with TF32 off), one wire byte at NVLink's 4.5e11 B/s a
    direction, 10 µs a collective launch (an assumed NCCL launch
    latency, not measured)."""

    fixed_s: float = 0.0
    sec_per_flop: float = 1.0 / 67e12
    sec_per_byte: float = 1.0 / 4.5e11
    sec_per_collective: float = 1.0e-5
    sec_per_dp_over_byte: float = 0.0
    source: str = f"analytic defaults ({CARD})"
    max_rel_error: float = float("nan")

    def as_vector(self) -> np.ndarray:
        return np.asarray([self.fixed_s, self.sec_per_flop,
                           self.sec_per_byte, self.sec_per_collective,
                           self.sec_per_dp_over_byte], float)


@dataclass
class Plan:
    best: Candidate
    candidates: List[Candidate]
    pruned_memory: int
    constants: CostConstants
    plan_seconds: float


# ---------------------------------------------------------------------------
# analytic terms
# ---------------------------------------------------------------------------
def _bubble(cand: Candidate, mc: ModelConfig) -> float:
    """Analytic bubble fraction — the exact ``schedule_info`` formulas."""
    S, V = cand.pp, cand.virtual_pp_degree
    M = max(1, cand.microbatches)
    if S <= 1:
        return 0.0
    fill = (S - 1) / V
    if cand.schedule == "zero_bubble":
        fb_total = 3.0 * M + max(0.0, 2.0 * fill - M)
    else:
        fb_total = 3.0 * M + 3.0 * fill
    return 1.0 - 3.0 * M / fb_total


def _choose_microbatches(batch: int, requested: int) -> int:
    m = max(1, min(int(requested), int(batch)))
    while batch % m != 0:
        m -= 1
    return m


_WIRE_ITEMSIZE = {"f32": 4.0, "bf16": 2.0, "int8": 1.0}


def _axis_bytes(cand: Candidate, mc: ModelConfig) -> Dict[str, float]:
    """Per-device wire bytes per step, by mesh axis — the analytic mirror
    of the ``comm_analysis`` ``per_axis`` attribution. Ring collective of
    size k moves 2·(k−1)/k of the payload per participant. Each axis is
    priced at ITS wire dtype (ModelConfig.mp_wire/grad_wire/
    zero_gather_wire): a quantized exchange moves the wire itemsize, not
    f32 — with the f32 defaults the model is byte-identical to the
    pre-wire-aware one, so the calibration fit is unchanged."""

    def ring(k: int) -> float:
        return 2.0 * (k - 1) / k if k > 1 else 0.0

    it_mp = _WIRE_ITEMSIZE[mc.mp_wire]
    it_dp = _WIRE_ITEMSIZE[mc.grad_wire]
    it_zg = _WIRE_ITEMSIZE[mc.zero_gather_wire]
    local_batch = mc.global_batch / max(1, cand.dp * cand.sharding)
    act_elems = local_batch * mc.seq_len * mc.hidden
    out: Dict[str, float] = {}
    # mp: 2 fwd + 2 bwd activation recombinations per layer (attn out +
    # mlp out), each moving act_elems at the activation wire dtype
    out["mp"] = 4.0 * mc.layers * act_elems * it_mp * ring(cand.mp)
    # sharding (ZeRO): all-gather params fwd (activation-wire gathered,
    # bf16-floored by mp_comm) + reduce-scatter grads bwd (grad wire) over
    # the model-parallel shard each device owns
    shard_params = mc.params / max(1, cand.mp * cand.pp)
    out["sharding"] = shard_params * (it_zg + it_dp) * ring(cand.sharding)
    # dp: gradient all-reduce of the per-device grad shard at the grad wire
    grad_pd = mc.params * it_dp / max(1, cand.mp * cand.pp * cand.sharding)
    out["dp"] = grad_pd * ring(cand.dp)
    # pp: boundary activations per microbatch, fwd + bwd, × virtual chunks
    # (point-to-point sends stay at the compute dtype — not quantized)
    act = act_elems * mc.dtype_bytes
    if cand.pp > 1:
        out["pp"] = 2.0 * act * cand.virtual_pp_degree
    else:
        out["pp"] = 0.0
    return out


def _collective_count(cand: Candidate, mc: ModelConfig) -> float:
    """Collective launches per step per device — the latency term."""
    M = max(1, cand.microbatches)
    n = 0.0
    if cand.mp > 1:
        n += 4.0 * mc.layers * M
    if cand.sharding > 1:
        n += 2.0 * _n_buckets(cand, mc)
    if cand.dp > 1:
        n += _n_buckets(cand, mc)
    if cand.pp > 1:
        n += 2.0 * M * cand.virtual_pp_degree
    return n


def _n_buckets(cand: Candidate, mc: ModelConfig) -> float:
    grad_mb = mc.params * 4 / (max(1, cand.mp * cand.pp) * 2 ** 20)
    return max(1.0, np.ceil(grad_mb / max(1, cand.bucket_mb)))


def _features(cand: Candidate, mc: ModelConfig,
              topo: Topology) -> np.ndarray:
    """Cost feature vector in host-aggregate units, aligned with
    ``CostConstants.as_vector``: [1, flops, wire_bytes, launches,
    dp_overcommit_bytes]. Every variable term is stretched by the
    analytic pipeline bubble — collectives idle through the fill/drain
    just like compute does."""
    stretch = 1.0 / max(1e-9, 1.0 - _bubble(cand, mc))
    ax = _axis_bytes(cand, mc)
    dcn_axes = _slice_crossing_axes(cand, topo)
    wire = sum(
        b * (topo.dcn_penalty if a in dcn_axes else 1.0)
        for a, b in ax.items())
    # dp overcommit: the gradient exchange observed on the emulated
    # fabric moves (dp-1)·payload per device, not the ring-optimal
    # 2(dp-1)/dp — charged separately so calibration can weigh it
    grad_pd = mc.params * mc.dtype_bytes / max(
        1, cand.mp * cand.pp * cand.sharding)
    dp_over = grad_pd * max(0, cand.dp - 1)
    if "dp" in dcn_axes:
        dp_over *= topo.dcn_penalty
    n = cand.ndev
    return np.asarray([
        1.0,
        mc.flops * stretch,
        wire * n * stretch,
        _collective_count(cand, mc) * n * stretch,
        dp_over * n * stretch,
    ], float)


def _slice_crossing_axes(cand: Candidate, topo: Topology) -> set:
    """Axes whose groups straddle the slice boundary. Mesh order is
    (dp, pp, sharding, sep, mp) with dp outermost — with ≥2 slices the
    boundary cuts the outermost non-trivial axis."""
    if topo.num_slices <= 1:
        return set()
    for a, k in (("dp", cand.dp), ("pp", cand.pp),
                 ("sharding", cand.sharding), ("mp", cand.mp)):
        if k > 1:
            return {a}
    return set()


def memory_bytes(cand: Candidate, mc: ModelConfig) -> float:
    """Analytic per-device footprint: params + grads + AdamW moments
    (ZeRO-sharded) + activations under the remat granularity."""
    pbytes = mc.params * mc.dtype_bytes
    model_shard = max(1, cand.mp * cand.pp)
    params = pbytes / model_shard
    grads = pbytes / model_shard
    # two f32 moments, weight-update-sharded over the sharding axis
    opt = 2.0 * mc.params * 4.0 / (model_shard * max(1, cand.sharding))
    local_batch = mc.global_batch / max(1, cand.dp * cand.sharding)
    per_layer = local_batch * mc.seq_len * mc.hidden * mc.dtype_bytes
    layers_live = mc.layers / max(1, cand.pp)
    act_factor = {"none": 8.0, "selective": 3.0, "full": 1.0}.get(
        mc.remat, 8.0)
    acts = per_layer * layers_live * act_factor
    return params + grads + opt + acts


# ---------------------------------------------------------------------------
# scoring + calibration
# ---------------------------------------------------------------------------
def score(cand: Candidate, mc: ModelConfig, topo: Topology,
          consts: CostConstants) -> Candidate:
    """Fill ``predicted_step_s`` (+ term breakdown) on a copy of ``cand``."""
    f = _features(cand, mc, topo)
    v = consts.as_vector()
    names = ("fixed_s", "compute_s", "comm_s", "latency_s", "dp_over_s")
    out = replace(cand)
    out.breakdown = {k: float(fi * vi) for k, fi, vi in zip(names, f, v)}
    # record what the byte model assumed crossed each axis's wire, so a
    # plan explains WHY a quantized layout ranked where it did
    out.wire_dtypes = {"mp": mc.mp_wire, "dp": mc.grad_wire,
                       "zero_gather": mc.zero_gather_wire}
    out.predicted_step_s = float(f @ v)
    return out


def _entry_candidate(entry: Dict[str, Any]) -> Candidate:
    mesh = entry.get("mesh", {})
    pipe = entry.get("pipeline") or {}
    return Candidate(
        dp=int(mesh.get("dp", 1)), mp=int(mesh.get("mp", 1)),
        pp=int(mesh.get("pp", 1)), sharding=int(mesh.get("sharding", 1)),
        schedule=str(pipe.get("schedule", "gpipe")),
        virtual_pp_degree=int(pipe.get("virtual_pp_degree", 1)),
        microbatches=int(pipe.get("microbatches", 1)))


def _entry_model(entry: Dict[str, Any], mc: ModelConfig) -> ModelConfig:
    # weak-scaling convention of the proxy: 2 sequences per device
    return replace(mc, global_batch=2 * int(entry["n"]))


def _solve_nonneg(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least squares with nonnegative coefficients, by exhaustive column
    subsets (5 columns → 31 subsets): negative constants would invert the
    ranking (rewarding comm-heavy layouts), so they are inadmissible.
    Residual ties (several subsets fit the few calibration points exactly)
    prefer solutions that keep the wire-byte term (column 2) — it is the
    term that differentiates mp/pp/sharding layouts at a fixed device
    count — and then more active terms."""
    ncol = A.shape[1]
    best, best_key = np.zeros(ncol), (np.inf, 1, 0)
    for mask in range(1, 2 ** ncol):
        cols = [j for j in range(ncol) if mask >> j & 1]
        sol, *_ = np.linalg.lstsq(A[:, cols], b, rcond=None)
        if np.any(sol < 0):
            continue
        full = np.zeros(ncol)
        full[cols] = sol
        res = float(np.linalg.norm(A @ full - b))
        key = (round(res, 9), 0 if (2 in cols and full[2] > 0) else 1,
               -int(np.count_nonzero(full)))
        if key < best_key:
            best, best_key = full, key
    return best


def calibrate(entries: Iterable[Dict[str, Any]],
              mc: Optional[ModelConfig] = None,
              topo: Optional[Topology] = None) -> CostConstants:
    """Fit (sec_per_flop, sec_per_byte, sec_per_collective) to the
    measured single-node proxy entries (each ``{"n", "mesh", "pipeline",
    "step_s"}``). Uses the same analytic features the predictor uses, so
    the fit IS the prediction error on the calibration set (recorded as
    ``max_rel_error``)."""
    mc = mc or ModelConfig()
    rows, targets = [], []
    for e in entries:
        if e.get("two_slice") or not e.get("ok", True):
            continue
        cand = _entry_candidate(e)
        emc = _entry_model(e, mc)
        t = Topology(n_devices=int(e["n"]),
                     host_serialized=(topo or Topology()).host_serialized)
        rows.append(_features(cand, emc, t))
        targets.append(float(e["step_s"]))
    if len(rows) < 2:
        return CostConstants()
    A = np.asarray(rows, float)
    b = np.asarray(targets, float)
    sol = _solve_nonneg(A, b)
    if not np.any(sol > 0):
        return CostConstants()
    pred = A @ sol
    rel = float(np.max(np.abs(pred - b) / np.maximum(b, 1e-12)))
    return CostConstants(
        fixed_s=float(sol[0]), sec_per_flop=float(sol[1]),
        sec_per_byte=float(sol[2]), sec_per_collective=float(sol[3]),
        sec_per_dp_over_byte=float(sol[4]),
        source=f"calibrated ({len(rows)} entries)",
        max_rel_error=rel)


#: the calibration measured on the card, beside this file
CALIBRATION_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "calibration_h100.json")


def read_calibration_doc(path: Optional[str] = None) -> dict:
    """The calibration document: ``{"card", "commit", "entries", ...}``
    (``chip_smoke.py`` phase 53c writes the entries). Raises ``OSError`` /
    ``ValueError`` when absent or unreadable."""
    with open(path or CALIBRATION_FILE) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("calibration document is not a JSON object")
    return doc


_CALIBRATION: Optional[CostConstants] = None


def load_calibration(path: Optional[str] = None,
                     mc: Optional[ModelConfig] = None) -> CostConstants:
    """Constants fitted to the card's calibration entries
    (``calibration_h100.json``, cached after the first load);
    ``CostConstants()`` when the file is absent or unusable — the planner
    still ranks, just uncalibrated."""
    global _CALIBRATION
    if path is None and mc is None and _CALIBRATION is not None:
        return _CALIBRATION
    try:
        doc = read_calibration_doc(path)
        entries = doc.get("entries", doc.get("results", []))
        consts = calibrate(entries, mc)
        if consts.source.startswith("calibrated"):
            where = os.path.basename(path or CALIBRATION_FILE)
            card = doc.get("card") or "card not recorded"
            consts.source = f"{where} ({card}; {consts.source[12:-1]})"
    except (OSError, ValueError, KeyError, TypeError):
        consts = CostConstants()
    if path is None and mc is None:
        _CALIBRATION = consts
    return consts


# ---------------------------------------------------------------------------
# enumeration + the plan
# ---------------------------------------------------------------------------
def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_candidates(mc: ModelConfig, topo: Topology,
                         pinned: Optional[Dict[str, Any]] = None
                         ) -> List[Candidate]:
    """Every divisibility-legal layout for ``topo.n_devices``. ``pinned``
    freezes knobs the user set manually ({"mp": 2, "schedule": "1f1b"} …)."""
    pinned = pinned or {}
    n = topo.n_devices
    out: List[Candidate] = []

    def ok(knob: str, v: int) -> bool:
        return knob not in pinned or int(pinned[knob]) == v

    for mp in _divisors(n):
        if not ok("mp", mp):
            continue
        if mp > 1 and (mc.heads % mp or mc.hidden % mp):
            continue
        for pp in _divisors(n // mp):
            if not ok("pp", pp):
                continue
            if pp > 1 and mc.layers % pp:
                continue
            for sh in _divisors(n // (mp * pp)):
                if not ok("sharding", sh):
                    continue
                dp = n // (mp * pp * sh)
                if not ok("dp", dp):
                    continue
                if mc.global_batch % (dp * sh):
                    continue
                for cand in _schedule_variants(mc, dp, mp, pp, sh, pinned):
                    out.append(cand)
    return out


def _schedule_variants(mc: ModelConfig, dp: int, mp: int, pp: int, sh: int,
                       pinned: Dict[str, Any]) -> Iterable[Candidate]:
    local_batch = mc.global_batch // max(1, dp * sh)
    if pp <= 1:
        # no pipeline: the schedule knobs are inert, but a user-pinned
        # value must ride through un-clobbered (manual settings win)
        yield Candidate(dp=dp, mp=mp, pp=pp, sharding=sh,
                        schedule=str(pinned.get("schedule", "gpipe")),
                        virtual_pp_degree=int(
                            pinned.get("virtual_pp_degree", 1)),
                        microbatches=1)
        return
    schedules = ("gpipe", "1f1b", "zero_bubble")
    if "schedule" in pinned:
        schedules = (str(pinned["schedule"]),)
    virtuals = (1, 2)
    if "virtual_pp_degree" in pinned:
        virtuals = (int(pinned["virtual_pp_degree"]),)
    for sched in schedules:
        for v in virtuals:
            if mc.layers % (pp * v):
                continue
            m = _choose_microbatches(local_batch, pp)
            yield Candidate(dp=dp, mp=mp, pp=pp, sharding=sh,
                            schedule=sched, virtual_pp_degree=v,
                            microbatches=m)


def plan(model_config: Optional[ModelConfig] = None,
         topology: Optional[Topology] = None,
         pinned: Optional[Dict[str, Any]] = None,
         constants: Optional[CostConstants] = None) -> Plan:
    """Enumerate → memory-prune → score → rank. Raises ValueError when no
    legal candidate survives (degrees that cannot divide the devices, or a
    memory bound nothing fits under)."""
    t0 = time.perf_counter()
    mc = model_config or ModelConfig()
    topo = topology or Topology()
    consts = constants or load_calibration(mc=None)
    cands = enumerate_candidates(mc, topo, pinned)
    n_enumerated = len(cands)
    fitting = [c for c in cands if memory_bytes(c, mc) <= topo.hbm_bytes]
    pruned = n_enumerated - len(fitting)
    if not fitting:
        raise ValueError(
            f"auto-plan found no legal layout for ndev={topo.n_devices} "
            f"(enumerated {n_enumerated}, memory-pruned {pruned})")
    scored = sorted((score(c, mc, topo, consts) for c in fitting),
                    key=lambda c: c.predicted_step_s)
    dt = time.perf_counter() - t0
    best = scored[0]
    _obs.set_gauge("autoplan_candidates", n_enumerated)
    _obs.set_gauge("autoplan_pruned_memory", pruned)
    _obs.set_gauge("autoplan_predicted_step_seconds", best.predicted_step_s)
    _obs.observe("autoplan_plan_seconds", dt)
    _obs.event("autoplan", mesh=best.mesh_dict(), schedule=best.schedule,
               virtual_pp_degree=best.virtual_pp_degree,
               microbatches=best.microbatches,
               predicted_step_s=round(best.predicted_step_s, 6),
               candidates=n_enumerated, pruned_memory=pruned,
               calibration=consts.source)
    return Plan(best=best, candidates=scored, pruned_memory=pruned,
                constants=consts, plan_seconds=dt)


# ---------------------------------------------------------------------------
# DistributedStrategy integration (manual settings always win)
# ---------------------------------------------------------------------------
def _pinned_from_strategy(strategy) -> Dict[str, Any]:
    """Knobs the user moved off their defaults — the planner must not
    touch them. dp_degree in (-1, 0, 1) is 'auto' (fleet.init fills it)."""
    pinned: Dict[str, Any] = {}
    hc = strategy.hybrid_configs
    for knob, key in (("dp", "dp_degree"), ("mp", "mp_degree"),
                      ("pp", "pp_degree"), ("sharding", "sharding_degree")):
        v = int(hc.get(key, 1))
        if v > 1:
            pinned[knob] = v
    pc = strategy.pipeline_configs
    if str(pc.get("schedule", "gpipe")) != "gpipe":
        pinned["schedule"] = str(pc["schedule"])
    if int(pc.get("virtual_pp_degree", 1)) != 1:
        pinned["virtual_pp_degree"] = int(pc["virtual_pp_degree"])
    return pinned


def _coerce_model_config(obj) -> ModelConfig:
    if isinstance(obj, ModelConfig):
        return obj
    if isinstance(obj, dict):
        known = {k: v for k, v in obj.items()
                 if k in ModelConfig.__dataclass_fields__}
        return ModelConfig(**known)
    return ModelConfig()


def apply_auto_plan(strategy, ndev: int,
                    topology: Optional[Topology] = None) -> Optional[Plan]:
    """Fill the un-set layout knobs of ``strategy`` from the cost model.

    Called by ``fleet.init`` when ``strategy.auto_plan`` or
    ``PADDLE_TPU_AUTO_PLAN=1``. Never raises: a planner failure leaves the
    strategy exactly as the user wrote it (and returns None)."""
    try:
        raw = getattr(strategy, "auto_plan_configs", {}).get("model_config")
        mc = _coerce_model_config(raw)
        explicit_batch = isinstance(raw, ModelConfig) or (
            isinstance(raw, dict) and "global_batch" in raw)
        if not explicit_batch:
            # weak-scaling default: 2 sequences per device, like the proxy
            mc = replace(mc, global_batch=max(mc.global_batch, 2 * ndev))
        # price the wires the strategy will actually run with: grad_comm's
        # dp gradient wire and mp_comm's activation/ZeRO-gather wires
        from .. import grad_comm as _gc
        from .. import mp_comm as _mpc

        gcfg = _gc.resolve_config(strategy)
        wcfg = _mpc.resolve_config(strategy)
        mc = replace(
            mc,
            grad_wire=(gcfg.wire_dtype if gcfg.enable else mc.grad_wire),
            mp_wire=wcfg.act_wire or mc.mp_wire,
            zero_gather_wire=wcfg.param_gather_wire or mc.zero_gather_wire)
        topo = topology or Topology(
            n_devices=ndev,
            num_slices=int(os.environ.get("PADDLE_TPU_NUM_SLICES", "1")))
        result = plan(mc, topo, pinned=_pinned_from_strategy(strategy))
    except Exception:  # noqa: BLE001 — planning must never block init
        return None
    best = result.best
    hc = strategy.hybrid_configs
    hc["dp_degree"] = best.dp
    hc["mp_degree"] = best.mp
    hc["pp_degree"] = best.pp
    hc["sharding_degree"] = best.sharding
    pc = strategy.pipeline_configs
    pc["schedule"] = best.schedule
    pc["virtual_pp_degree"] = best.virtual_pp_degree
    pc["accumulate_steps"] = best.microbatches
    strategy.pipeline = best.pp > 1
    _obs.inc("autoplan_applied_total", ndev=ndev)
    return result


# ---------------------------------------------------------------------------
# MPMD stage plans: per-stage width candidates
# ---------------------------------------------------------------------------
# The SPMD planner above picks ONE (dp, mp, pp, sharding) for the whole
# program, so every pipeline stage gets the same data-parallel width. The
# MPMD executor (distributed/mpmd.py) lifts that restriction: each stage
# is its own runner on its own device subset, so a stack whose layers are
# unevenly expensive can give the heavy stage more devices.
# ``plan_mpmd_stages`` enumerates those per-stage widths, prices the
# bottleneck-stage tick with the same calibrated constants, and charges
# boundary respec traffic through ``reshard.plan_boundary`` at the
# RESOLVED wire dtype — the moved bytes of an int8 boundary are a quarter
# of an f32 one, which is exactly what the tensor-queue transport ships.

@dataclass
class StagePlan:
    """One MPMD layout candidate: per-stage widths + the layer split the
    runtime will actually use (contiguous, remainder to the front — the
    mirror of ``mpmd._partition``)."""

    widths: List[int] = field(default_factory=list)
    layer_split: List[Tuple[int, int]] = field(default_factory=list)
    microbatches: int = 1
    wire: str = "f32"
    # filled by _score_stage_plan()
    predicted_step_s: float = 0.0
    breakdown: Dict[str, float] = field(default_factory=dict)
    boundary_bytes: float = 0.0          # wire bytes per step, all boundaries
    stage_tick_s: List[float] = field(default_factory=list)

    @property
    def equal_width(self) -> bool:
        return len(set(self.widths)) <= 1

    def to_json(self) -> Dict[str, Any]:
        return {
            "widths": list(self.widths),
            "layer_split": [list(s) for s in self.layer_split],
            "microbatches": self.microbatches,
            "wire": self.wire,
            "predicted_step_s": self.predicted_step_s,
            "boundary_bytes": self.boundary_bytes,
            "breakdown": dict(self.breakdown),
        }


@dataclass
class MpmdPlan:
    best: StagePlan
    best_equal: Optional[StagePlan]
    candidates: List[StagePlan]
    constants: CostConstants
    plan_seconds: float


def _split_layers(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous layer ranges per stage, remainder to the FRONT stages —
    must stay in lockstep with ``mpmd._partition`` so the planner prices
    the split the executor actually builds."""
    base, rem = divmod(n_layers, n_stages)
    out, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _stage_compositions(n_devices: int, n_stages: int) -> List[List[int]]:
    """All ways to split ``n_devices`` into ``n_stages`` positive widths
    (order matters: stage 0's width is the first entry)."""
    if n_stages == 1:
        return [[n_devices]]
    out: List[List[int]] = []
    for w in range(1, n_devices - n_stages + 2):
        for rest in _stage_compositions(n_devices - w, n_stages - 1):
            out.append([w] + rest)
    return out


def _score_stage_plan(sp: StagePlan, mc: ModelConfig, topo: Topology,
                      consts: CostConstants,
                      layer_costs: List[float]) -> StagePlan:
    """Fill ``predicted_step_s`` on a copy of ``sp``.

    Tick model: ``sec_per_flop`` is calibrated in host-aggregate units
    (all ``n_devices`` participating), so a stage running its share on
    ``dp_i`` devices ticks at ``sec_per_flop · n · flops_i / dp_i``. A
    1f1b step is ``M + S − 1`` ticks of the BOTTLENECK stage — widening
    the heavy stage shrinks the max, which is the whole point of MPMD.
    Boundary traffic is priced per microbatch through
    ``reshard.plan_boundary`` (activation forward + cotangent backward)
    at the wire itemsize, plus a per-send collective-launch charge."""
    from ..reshard import plan_boundary as _plan_boundary

    S = len(sp.widths)
    M = max(1, sp.microbatches)
    total_cost = sum(layer_costs) or 1.0
    it = _WIRE_ITEMSIZE[sp.wire]
    # the host-serialized calibration can fit sec_per_flop to exactly 0
    # (compute gets attributed to the fixed/byte terms); widths would
    # then be indistinguishable, so fall back to the default proxy-scale
    # flop rate for the WIDTH decision — relative stage weights are what
    # matter here, not the absolute seconds
    spf = consts.sec_per_flop or CostConstants().sec_per_flop
    out = replace(sp)
    out.stage_tick_s = []
    for (lo, hi), dp in zip(sp.layer_split, sp.widths):
        frac = sum(layer_costs[lo:hi]) / total_cost
        flops_mb = mc.flops * frac / M
        out.stage_tick_s.append(
            spf * topo.n_devices * flops_mb / max(1, dp))
    tick = max(out.stage_tick_s) if out.stage_tick_s else 0.0
    compute_s = (M + S - 1) * tick
    mb_shape = (max(1, mc.global_batch // M), mc.seq_len, mc.hidden)
    boundary_b = 0.0
    for b in range(S - 1):
        lp = _plan_boundary(
            mb_shape, "float32", sp.widths[b], sp.widths[b + 1],
            wire_itemsize=int(it), key=f"act{b}")
        # activation fwd + cotangent bwd, every microbatch
        boundary_b += 2.0 * M * lp.moved_bytes
    boundary_s = consts.sec_per_byte * boundary_b
    latency_s = consts.sec_per_collective * 2.0 * M * (S - 1)
    out.boundary_bytes = float(boundary_b)
    out.breakdown = {"fixed_s": consts.fixed_s,
                     "compute_s": float(compute_s),
                     "boundary_s": float(boundary_s),
                     "latency_s": float(latency_s)}
    out.predicted_step_s = float(
        consts.fixed_s + compute_s + boundary_s + latency_s)
    return out


def plan_mpmd_stages(model_config: Optional[ModelConfig] = None,
                     topology: Optional[Topology] = None, *,
                     num_stages: int = 2,
                     wire: str = "f32",
                     layer_costs: Optional[List[float]] = None,
                     microbatches: Optional[int] = None,
                     constants: Optional[CostConstants] = None) -> MpmdPlan:
    """Enumerate per-stage width compositions for an MPMD pipeline and
    rank them by predicted step time.

    ``layer_costs`` gives each layer's relative compute weight (default
    uniform). On a balanced stack the equal-width composition wins; on an
    unbalanced one the planner shifts devices onto the bottleneck stage —
    ``MpmdPlan.best_equal`` keeps the best equal-width candidate around
    so callers (scripts/scaling_model.py) can record the A/B delta."""
    t0 = time.perf_counter()
    mc = model_config or ModelConfig()
    topo = topology or Topology()
    consts = constants or load_calibration(mc=None)
    if wire not in _WIRE_ITEMSIZE:
        raise ValueError(f"unknown wire {wire!r}; want one of "
                         f"{sorted(_WIRE_ITEMSIZE)}")
    if not 1 <= num_stages <= topo.n_devices:
        raise ValueError(
            f"num_stages={num_stages} needs 1..{topo.n_devices} stages")
    if num_stages > mc.layers:
        raise ValueError(
            f"num_stages={num_stages} exceeds {mc.layers} layers")
    costs = list(layer_costs) if layer_costs else [1.0] * mc.layers
    if len(costs) != mc.layers:
        raise ValueError(
            f"layer_costs has {len(costs)} entries for {mc.layers} layers")
    M = _choose_microbatches(mc.global_batch,
                             microbatches or 2 * num_stages)
    split = _split_layers(mc.layers, num_stages)
    cands = [
        _score_stage_plan(
            StagePlan(widths=w, layer_split=split, microbatches=M,
                      wire=wire),
            mc, topo, consts, costs)
        for w in _stage_compositions(topo.n_devices, num_stages)
    ]
    # ties break toward balanced widths (smaller spread), then lexicographic
    cands.sort(key=lambda sp: (sp.predicted_step_s,
                               max(sp.widths) - min(sp.widths),
                               tuple(sp.widths)))
    best = cands[0]
    equal = [sp for sp in cands if sp.equal_width]
    best_equal = equal[0] if equal else None
    dt = time.perf_counter() - t0
    _obs.observe("autoplan_plan_seconds", dt)
    _obs.event("autoplan", variant="mpmd", widths=list(best.widths),
               microbatches=M, wire=wire,
               predicted_step_s=round(best.predicted_step_s, 6),
               candidates=len(cands), calibration=consts.source)
    return MpmdPlan(best=best, best_equal=best_equal, candidates=cands,
                    constants=consts, plan_seconds=dt)


# ---------------------------------------------------------------------------
# attention-kernel pricing
# ---------------------------------------------------------------------------

@dataclass
class AttnKernelPlan:
    """Analytic HBM-traffic comparison of the two paged-attention
    implementations for ONE batched decode/verify step (all layers).

    The field values are the reference's (``"pallas"`` / ``"einsum"``),
    so event records compare equal across the packages: ``"pallas"``
    names the fused kernel, which in the port is K3
    (``ops/cuda/paged_attention.cu``), and ``"einsum"`` the unfused plain
    version. ``einsum_bytes`` models the plain version: (int8 only) a
    whole-pool dequant pass per layer, the gathered K/V pages written and
    re-read as f32, and the dense logits tensor round-tripped through
    HBM. ``pallas_bytes`` models the fused kernel: the gathered pages
    stream from HBM once at their STORED dtype (+ absmax scales when
    int8); logits, softmax stats, and the accumulator stay on chip.
    Decode is HBM-bound, so predicted step times are bytes / hbm_bw."""

    choice: str                    # cheaper side: "pallas" | "einsum"
    selected: Optional[str]        # what the engine actually resolved
    einsum_bytes: float
    pallas_bytes: float
    einsum_step_s: float
    pallas_step_s: float
    bytes_saved: float             # einsum_bytes - pallas_bytes

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def plan_attn_kernel(*, num_slots: int, max_pages: int, kv_heads: int,
                     query_heads: int, page_size: int, head_dim: int,
                     layers: int, kv_dtype: str = "f32", t: int = 1,
                     num_pages: Optional[int] = None,
                     selected: Optional[str] = None,
                     topology: Optional[Topology] = None) -> AttnKernelPlan:
    """Price the engine's paged-attention kernel choice per decode step.

    Mirrors the serving geometry (EngineConfig + decode adapter): S slots
    each gathering ``max_pages`` pages of ``page_size`` tokens over
    ``kv_heads`` kv heads (GQA: ``query_heads`` fold onto them, free in
    both paths), ``t`` query rows per slot (1 = decode, k+1 = verify).
    ``num_pages`` sizes the int8 whole-pool dequant pass the einsum path
    pays (default: the slots' worst-case footprint). Emits the standard
    ``autoplan`` event with ``variant="attn_kernel"`` so the decision —
    and what the engine actually selected — lands in telemetry."""
    if kv_dtype not in _WIRE_ITEMSIZE:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; want one of "
                         f"{sorted(_WIRE_ITEMSIZE)}")
    topo = topology or Topology()
    it = _WIRE_ITEMSIZE[kv_dtype]
    int8 = kv_dtype == "int8"
    pool_pages = num_pages if num_pages is not None else (
        1 + num_slots * max_pages)
    gathered = num_slots * max_pages * page_size * kv_heads * head_dim
    logits = num_slots * query_heads * t * max_pages * page_size

    # oracle: (int8) dequant pass reads the stored pool and writes it
    # f32; the gather writes + the einsum re-reads gathered f32 K AND V;
    # the masked logits round-trip HBM (write + softmax read)
    dequant = (2 * pool_pages * kv_heads * page_size * head_dim * (it + 4.0)
               if int8 else 0.0)
    gather_src = 4.0 if int8 else it   # gathers read the dequantized pool
    einsum_bytes = layers * (
        dequant
        + 2 * gathered * (gather_src + 2 * 4.0)
        + 2 * logits * 4.0)
    # fused kernel: pages stream once at stored width (+ scale vectors)
    scales = (2 * num_slots * max_pages * page_size * kv_heads * 4.0
              if int8 else 0.0)
    pallas_bytes = layers * (2 * gathered * it + scales)

    plan_ = AttnKernelPlan(
        choice="pallas" if pallas_bytes <= einsum_bytes else "einsum",
        selected=selected,
        einsum_bytes=float(einsum_bytes),
        pallas_bytes=float(pallas_bytes),
        einsum_step_s=float(einsum_bytes / topo.hbm_bw),
        pallas_step_s=float(pallas_bytes / topo.hbm_bw),
        bytes_saved=float(einsum_bytes - pallas_bytes),
    )
    _obs.event("autoplan", variant="attn_kernel", choice=plan_.choice,
               selected=selected, kv_dtype=kv_dtype,
               einsum_bytes=plan_.einsum_bytes,
               pallas_bytes=plan_.pallas_bytes,
               predicted_einsum_step_s=round(plan_.einsum_step_s, 9),
               predicted_pallas_step_s=round(plan_.pallas_step_s, 9))
    return plan_
