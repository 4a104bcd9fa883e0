"""The port's cost-model auto-parallel planner
(``paddle_tpu_torch/distributed/auto_parallel/planner.py``) held against
the reference's (``paddle_tpu/distributed/auto_parallel/planner.py``),
mirroring ``tests/test_autoplan.py``.

Both planners run on the same inputs: the same ``ModelConfig`` fields, an
explicit ``Topology`` built from the same keyword arguments (the port's
defaults are the H100's, the reference's TPU v4's, so no comparison rests
on a default), the same calibration entries (the reference's
``MULTICHIP_SCALING.json`` proxies and a seeded synthetic set) and the
same ``CostConstants`` values. Tolerance: 1e-12 relative on every
predicted time, fitted constant and byte count (the arithmetic is the
same numpy in the same order; only summation order inside BLAS could
move a last bit), exact on degrees, orders and choices.

``load_calibration()`` without a path reads the port's own
``calibration_h100.json`` and never the TPU / CPU-proxy scaling file.
"""
import json
import os

import numpy as np
import pytest

from paddle_tpu.distributed.auto_parallel import planner as ref
from paddle_tpu.distributed.fleet import DistributedStrategy as RefStrategy
from paddle_tpu_torch.distributed.auto_parallel import planner as port
from paddle_tpu_torch.distributed.fleet import DistributedStrategy

from torch_port_utils import same_planner_constants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALING = os.path.join(REPO, "MULTICHIP_SCALING.json")
RTOL = 1e-12
TOPO = dict(n_devices=8, ici_bw=1.6e11, dcn_bw=3.1e9, peak_flops=197e12,
            hbm_bytes=32e9, hbm_bw=1.2e12)


def _ref_entries():
    with open(SCALING) as f:
        return [e for e in json.load(f)["results"]
                if e.get("ok") and not e.get("two_slice")]


def _synthetic_entries(seed=0):
    """Weak-scaling entries of the shape phase 53c measures: six layouts
    at n = 2 and n = 4 with step times drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    layouts = [(2, dict(dp=2)), (2, dict(mp=2)), (2, dict(pp=2)),
               (2, dict(sharding=2)), (4, dict(mp=2, pp=2)),
               (4, dict(dp=2, sharding=2))]
    out = []
    for n, mesh in layouts:
        mesh = {k: mesh.get(k, 1) for k in ("dp", "mp", "pp", "sharding")}
        pipe = ({"schedule": "1f1b", "virtual_pp_degree": 1,
                 "microbatches": 2} if mesh["pp"] > 1 else None)
        out.append({"n": n, "mesh": mesh, "pipeline": pipe,
                    "step_s": float(rng.uniform(0.01, 0.05)), "ok": True})
    return out


def _close(a, b, what=""):
    assert a == pytest.approx(b, rel=RTOL, abs=0.0), what


def _consts(pkg, c):
    return pkg.CostConstants(
        fixed_s=c.fixed_s, sec_per_flop=c.sec_per_flop,
        sec_per_byte=c.sec_per_byte, sec_per_collective=c.sec_per_collective,
        sec_per_dp_over_byte=c.sec_per_dp_over_byte)


def _same_candidate(a, b):
    assert (a.dp, a.mp, a.pp, a.sharding, a.schedule, a.virtual_pp_degree,
            a.microbatches, a.bucket_mb, a.wire_dtypes) == \
        (b.dp, b.mp, b.pp, b.sharding, b.schedule, b.virtual_pp_degree,
         b.microbatches, b.bucket_mb, b.wire_dtypes)
    _close(a.predicted_step_s, b.predicted_step_s)
    assert a.breakdown.keys() == b.breakdown.keys()
    for k in a.breakdown:
        _close(a.breakdown[k], b.breakdown[k], k)


# -- enumeration, memory, scoring ----------------------------------------

@pytest.mark.parametrize("ndev", [8, 16, 32])
def test_enumeration_and_memory_match(ndev):
    kw = dict(global_batch=2 * ndev)
    got = port.enumerate_candidates(port.ModelConfig(**kw),
                                    port.Topology(**dict(TOPO, n_devices=ndev)))
    want = ref.enumerate_candidates(ref.ModelConfig(**kw),
                                    ref.Topology(**dict(TOPO, n_devices=ndev)))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.mesh_dict() == b.mesh_dict()
        assert (a.schedule, a.virtual_pp_degree, a.microbatches) == \
            (b.schedule, b.virtual_pp_degree, b.microbatches)
        for remat in ("none", "selective", "full"):
            _close(port.memory_bytes(a, port.ModelConfig(remat=remat, **kw)),
                   ref.memory_bytes(b, ref.ModelConfig(remat=remat, **kw)))
    pinned = {"mp": 2, "pp": 2}
    got = port.enumerate_candidates(port.ModelConfig(**kw),
                                    port.Topology(**dict(TOPO, n_devices=ndev)),
                                    pinned)
    assert got and all(c.mp == 2 and c.pp == 2 for c in got)


@pytest.mark.parametrize("wires", [("f32", "f32", "f32"),
                                   ("int8", "bf16", "bf16")])
def test_score_matches_on_every_candidate(wires):
    mp_w, gw, zw = wires
    kw = dict(global_batch=16, mp_wire=mp_w, grad_wire=gw,
              zero_gather_wire=zw)
    mc_p, mc_r = port.ModelConfig(**kw), ref.ModelConfig(**kw)
    rc = ref.calibrate(_ref_entries())
    cp = _consts(port, rc)
    for slices in (1, 2):
        tp = port.Topology(**dict(TOPO, num_slices=slices))
        tr = ref.Topology(**dict(TOPO, num_slices=slices))
        for a, b in zip(port.enumerate_candidates(mc_p, tp),
                        ref.enumerate_candidates(mc_r, tr)):
            _same_candidate(port.score(a, mc_p, tp, cp),
                            ref.score(b, mc_r, tr, rc))
            assert port._bubble(a, mc_p) == ref._bubble(b, mc_r)
            ax_p, ax_r = port._axis_bytes(a, mc_p), ref._axis_bytes(b, mc_r)
            assert ax_p == ax_r


def test_plan_ranks_like_the_reference():
    mc_p, mc_r = port.ModelConfig(global_batch=16), ref.ModelConfig(
        global_batch=16)
    rc = ref.calibrate(_ref_entries())
    got = port.plan(mc_p, port.Topology(**TOPO), constants=_consts(port, rc))
    want = ref.plan(mc_r, ref.Topology(**TOPO), constants=rc)
    assert got.pruned_memory == want.pruned_memory
    assert len(got.candidates) == len(want.candidates) > 10
    for a, b in zip(got.candidates, want.candidates):
        _same_candidate(a, b)
    # a memory bound that drops the unsharded layouts, and one nothing fits
    need = ref.memory_bytes(ref.Candidate(dp=8), mc_r)
    for hbm in (need * 0.9, 1024):
        tp = port.Topology(**dict(TOPO, hbm_bytes=hbm))
        tr = ref.Topology(**dict(TOPO, hbm_bytes=hbm))
        if hbm == 1024:
            with pytest.raises(ValueError):
                port.plan(mc_p, tp, constants=_consts(port, rc))
            continue
        a = port.plan(mc_p, tp, constants=_consts(port, rc))
        b = ref.plan(mc_r, tr, constants=rc)
        assert a.pruned_memory == b.pruned_memory > 0
        _same_candidate(a.best, b.best)


@pytest.mark.parametrize("entries", ["reference", "synthetic"])
def test_calibrate_matches(entries):
    es = _ref_entries() if entries == "reference" else _synthetic_entries()
    got, want = port.calibrate(es), ref.calibrate(es)
    np.testing.assert_allclose(got.as_vector(), want.as_vector(), rtol=RTOL,
                               atol=0.0)
    _close(got.max_rel_error, want.max_rel_error)
    assert (got.as_vector() >= 0).all() and got.as_vector().sum() > 0
    # the fit IS the prediction error on its entries
    for e in es:
        mc = port._entry_model(e, port.ModelConfig())
        pred = port.score(port._entry_candidate(e), mc,
                          port.Topology(n_devices=int(e["n"])), got)
        rel = abs(pred.predicted_step_s - e["step_s"]) / e["step_s"]
        assert rel <= got.max_rel_error + 1e-9
    # fewer than two usable entries: the analytic fallback, in each package
    assert port.calibrate(es[:1]).source == port.CostConstants().source


def test_plan_mpmd_stages_matches():
    # a fit may zero sec_per_flop (the reference's does); each planner then
    # prices the width decision at its own analytic flop rate, which is the
    # card's in the port: compare on a nonzero rate, then check the
    # fallback separately
    import dataclasses

    rc = dataclasses.replace(ref.calibrate(_ref_entries()),
                             sec_per_flop=2.0e-10)
    for n, stages, wire, costs in ((4, 2, "f32", None),
                                   (5, 2, "int8", [1.0, 1.0, 3.0, 3.0]),
                                   (6, 3, "bf16", None)):
        kw = dict(num_stages=stages, wire=wire, layer_costs=costs)
        got = port.plan_mpmd_stages(port.ModelConfig(),
                                    port.Topology(**dict(TOPO, n_devices=n)),
                                    constants=_consts(port, rc), **kw)
        want = ref.plan_mpmd_stages(ref.ModelConfig(),
                                    ref.Topology(**dict(TOPO, n_devices=n)),
                                    constants=rc, **kw)
        assert len(got.candidates) == len(want.candidates)
        for a, b in zip(got.candidates + [got.best_equal],
                        want.candidates + [want.best_equal]):
            if b is None:
                assert a is None
                continue
            assert (a.widths, a.layer_split, a.microbatches, a.wire) == \
                (b.widths, b.layer_split, b.microbatches, b.wire)
            _close(a.predicted_step_s, b.predicted_step_s)
            _close(a.boundary_bytes, b.boundary_bytes)
            for x, y in zip(a.stage_tick_s, b.stage_tick_s):
                _close(x, y)
    zero = port.CostConstants(sec_per_flop=0.0)
    got = port.plan_mpmd_stages(port.ModelConfig(), port.Topology(n_devices=4),
                                constants=zero)
    want = port.plan_mpmd_stages(port.ModelConfig(),
                                 port.Topology(n_devices=4),
                                 constants=port.CostConstants())
    _close(got.best.breakdown["compute_s"], want.best.breakdown["compute_s"])
    # the planner's layer split is the executor's partition
    from paddle_tpu_torch.distributed.mpmd import _partition

    for n_layers in range(1, 9):
        for stages in range(1, n_layers + 1):
            assert port._split_layers(n_layers, stages) == \
                _partition(n_layers, stages)
    with pytest.raises(ValueError):
        port.plan_mpmd_stages(port.ModelConfig(), port.Topology(n_devices=2),
                              num_stages=3)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_plan_attn_kernel_matches(kv):
    kw = dict(num_slots=8, max_pages=64, kv_heads=8, query_heads=32,
              page_size=16, head_dim=128, layers=24, kv_dtype=kv, t=5,
              selected="pallas")
    got = port.plan_attn_kernel(topology=port.Topology(**TOPO), **kw)
    want = ref.plan_attn_kernel(topology=ref.Topology(**TOPO), **kw)
    a, b = got.to_dict(), want.to_dict()
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], float):
            _close(a[k], b[k], k)
        else:
            assert a[k] == b[k], k
    # at the card's HBM rate (the port's default topology)
    h100 = port.plan_attn_kernel(**kw)
    _close(h100.pallas_step_s, h100.pallas_bytes / 3.35e12)


# -- defaults: the card's own numbers -------------------------------------

def test_defaults_are_the_cards_and_calibration_is_its_own():
    t = port.Topology()
    assert (t.ici_bw, t.dcn_bw, t.peak_flops, t.hbm_bytes, t.hbm_bw) == \
        (4.5e11, 5.0e10, 989e12, 80e9, 3.35e12)
    assert "H100" in port.Topology.__doc__ and "700 W" in \
        port.Topology.__doc__
    assert "H100" in port.CostConstants().source
    assert os.path.basename(port.CALIBRATION_FILE) == "calibration_h100.json"
    doc = port.read_calibration_doc()
    assert "H100" in doc["card"] and doc["commit"]
    assert len(doc["entries"]) >= 6
    consts = port.load_calibration(path=port.CALIBRATION_FILE)
    assert "calibration_h100.json" in consts.source and "H100" in \
        consts.source
    v = consts.as_vector()
    assert np.isfinite(v).all() and (v >= 0).all() and (v > 0).any()
    _close(consts.max_rel_error, ref.calibrate(doc["entries"]).max_rel_error)
    # no file: the analytic fallback, never the scaling records
    fallback = port.load_calibration(path="/nonexistent/calibration.json")
    assert (fallback.as_vector() == port.CostConstants().as_vector()).all()
    assert fallback.source == port.CostConstants().source
    src = open(port.__file__).read()
    assert "MULTICHIP_SCALING" not in src


# -- strategy integration -------------------------------------------------

def test_auto_strategy_flag():
    s = DistributedStrategy()
    assert not s.auto_plan
    a = DistributedStrategy.auto({"hidden": 128})
    b = RefStrategy.auto({"hidden": 128})
    assert a.auto_plan and b.auto_plan
    assert a.auto_plan_configs["model_config"] == \
        b.auto_plan_configs["model_config"]


@pytest.mark.parametrize("case", ["unset", "pinned", "wires", "bad_mp",
                                  "model_dict"])
def test_apply_auto_plan_degrees_match(case, monkeypatch):
    same_planner_constants(monkeypatch)
    monkeypatch.delenv("PADDLE_TPU_GRAD_COMM", raising=False)
    monkeypatch.delenv("PADDLE_TPU_MP_COMM", raising=False)
    if case == "wires":
        monkeypatch.setenv("PADDLE_TPU_MP_COMM", "int8")
    out = []
    for pkg, strat in ((port, DistributedStrategy), (ref, RefStrategy)):
        s = strat.auto({"hidden": 128, "heads": 8, "layers": 8}
                       if case == "model_dict" else None)
        if case == "pinned":
            s.hybrid_configs["mp_degree"] = 2
            s.pipeline_configs["schedule"] = "1f1b"
        if case == "bad_mp":
            s.hybrid_configs["mp_degree"] = 3
        before = dict(s.hybrid_configs)
        res = pkg.apply_auto_plan(s, ndev=8,
                                  topology=pkg.Topology(**TOPO))
        if case == "bad_mp":
            assert res is None and dict(s.hybrid_configs) == before
        out.append((dict(s.hybrid_configs), dict(s.pipeline_configs),
                    s.pipeline, None if res is None else res.best))
    (hp, pp_, pl, bp), (hr, pr, rl, br) = out
    assert hp == hr and pp_ == pr and pl == rl
    if br is not None:
        _same_candidate(bp, br)
    if case == "pinned":
        assert hp["mp_degree"] == 2 and pp_["schedule"] == "1f1b"
    if case == "wires":
        assert bp.wire_dtypes["mp"] == "int8"
        assert bp.wire_dtypes["zero_gather"] == "bf16"


def test_default_prices_come_from_the_planner():
    from paddle_tpu_torch.observability import accounting

    prices = accounting.default_prices()
    want = accounting.Prices.from_cost_constants(port.load_calibration())
    assert prices.to_dict() == want.to_dict()
    assert "H100" in prices.source
