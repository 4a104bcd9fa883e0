"""The reshard planner and executor of the PyTorch port
(``paddle_tpu_torch/distributed/reshard.py``) against the reference's
(``paddle_tpu/distributed/reshard.py``).

The planner is pure Python on both sides: over a sweep of spec pairs,
shapes, dtypes and axis sizes (those of the reference's
``tests/test_reshard.py`` among them) ``plan_same_mesh``,
``plan_cross_mesh``, ``plan_boundary`` and ``plan_restore_spec`` give the
reference's steps, ``peak_bytes`` and ``moved_bytes`` exactly, and the
layout records have the reference's documents. The executor runs at world
size 4 on the CPU (gloo, one spawn): every pair of specs on a dp 2 x mp 2
mesh, in f32 and bf16, gives the target's block of the source values, with
``collective.counts["reshard_moved_bytes"]`` the plan's; ``reshard_state``
is two-phase and refuses what it cannot host; ``deadline_guard`` raises
on a stall and is silent on the clean path.
"""
import json
import time

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu.distributed.reshard as ref
from paddle_tpu.distributed.checkpoint import manifest as ref_manifest

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed import reshard as port
from paddle_tpu_torch.distributed.checkpoint import manifest

from torch_port_utils import (RESHARD_SHAPE, RESHARD_SPECS, fleet_jobs,
                              join_ranks, spawn_ranks)

WORLD = 4
DEVS = np.array(jax.devices())
SIZES = [{"dp": 2, "mp": 2}, {"dp": 2, "mp": 4}, {"dp": 4, "mp": 2}]
SHAPES = [(8, 8), (16, 32), (1024, 1024)]
DTYPES = ["float32", "bfloat16"]


def _plan_doc(plan):
    return (plan.key, plan.shape, plan.dtype, plan.transfer, plan.peak_bytes,
            plan.moved_bytes,
            [(s.kind, s.axis, s.spec, s.in_bytes, s.out_bytes)
             for s in plan.steps])


def _ids(specs):
    return [repr(s) for s in specs]


@pytest.mark.parametrize("src", RESHARD_SPECS, ids=_ids(RESHARD_SPECS))
@pytest.mark.parametrize("dst", RESHARD_SPECS, ids=_ids(RESHARD_SPECS))
def test_plan_same_mesh_matches_reference(src, dst):
    """Every pair of specs, at each shape, dtype and axis sizes: the
    reference's plan step for step, byte for byte."""
    for shape in SHAPES:
        for dtype in DTYPES:
            for sizes in SIZES:
                want = ref.plan_same_mesh(shape, dtype, P(*src), P(*dst),
                                          sizes, key="w")
                got = port.plan_same_mesh(shape, dtype, src, dst, sizes,
                                          key="w")
                assert _plan_doc(got) == _plan_doc(want), (shape, dtype,
                                                           sizes)


@pytest.mark.parametrize("case", [
    ("noop", (8, 8), ("dp",), ("dp",), {"dp": 2, "mp": 2}),
    ("moved_axis", (8, 8), ("dp",), (None, "dp"), {"dp": 2, "mp": 2}),
    ("slice_before_gather", (8, 8), ("dp",), ("mp",), {"dp": 2, "mp": 4}),
    ("align", (8, 8), (("dp", "mp"),), (("mp", "dp"),),
     {"dp": 2, "mp": 2}),
    ("large_leaf", (1024, 1024), ("dp", "mp"), ("dp",), {"dp": 2, "mp": 2}),
], ids=lambda c: c[0])
def test_reference_planner_units(case):
    """``tests/test_reshard.py::TestPlanner``'s cases (:51-107): the
    reference's plan and its properties."""
    name, shape, src, dst, sizes = case
    got = port.plan_same_mesh(shape, "float32", src, dst, sizes)
    want = ref.plan_same_mesh(shape, "float32", P(*src), P(*dst), sizes)
    assert _plan_doc(got) == _plan_doc(want)
    kinds = [s.kind for s in got.steps]
    naive = port.naive_gather_bytes(shape, "float32")
    assert naive == ref.naive_gather_bytes(shape, "float32")
    if name == "noop":
        assert got.steps == [] and got.peak_bytes == 8 * 8 * 4 // 2
    elif name == "moved_axis":
        assert kinds == ["all_to_all"]
        assert got.steps[0].in_bytes == got.steps[0].out_bytes
    elif name == "slice_before_gather":
        assert kinds.index("slice") < kinds.index("all_gather")
        assert got.peak_bytes < naive
    elif name == "align":
        assert kinds == ["align"] and got.steps[-1].spec == (("mp", "dp"),
                                                             ())
    else:
        assert got.peak_bytes <= naive // 4 + naive // 2


def test_bf16_accounting():
    p32 = port.plan_same_mesh((64, 64), "float32", ("dp",), (), {"dp": 2})
    p16 = port.plan_same_mesh((64, 64), "bfloat16", ("dp",), (), {"dp": 2})
    assert p16.peak_bytes * 2 == p32.peak_bytes
    import torch

    pt = port.plan_same_mesh((64, 64), torch.bfloat16, ("dp",), (),
                             {"dp": 2})
    assert _plan_doc(pt) == _plan_doc(p16)


@pytest.mark.parametrize("src", RESHARD_SPECS[:5], ids=_ids(RESHARD_SPECS[:5]))
@pytest.mark.parametrize("sizes", [({"dp": 4}, {"dp": 2}),
                                   ({"dp": 2, "mp": 2}, {"dp": 4}),
                                   ({"dp": 1, "mp": 4}, {"dp": 2, "mp": 2})],
                         ids=["dp4-dp2", "dp2mp2-dp4", "mp4-dp2mp2"])
def test_plan_cross_mesh_matches_reference(src, sizes):
    for dst in RESHARD_SPECS:
        want = ref.plan_cross_mesh((8, 16), "float32", P(*src), sizes[0],
                                   P(*dst), sizes[1], key="w")
        got = port.plan_cross_mesh((8, 16), "float32", src, sizes[0], dst,
                                   sizes[1], key="w")
        assert _plan_doc(got) == _plan_doc(want)


@pytest.mark.parametrize("widths", [(1, 4), (4, 1), (2, 4), (8, 2)])
def test_plan_boundary_matches_reference(widths):
    for dtype, wire in (("float32", None), ("float32", 2), ("bfloat16", 1)):
        want = ref.plan_boundary((8, 16, 32), dtype, *widths,
                                 wire_itemsize=wire, key="act")
        got = port.plan_boundary((8, 16, 32), dtype, *widths,
                                 wire_itemsize=wire, key="act")
        assert _plan_doc(got) == _plan_doc(want)


RESTORE_CASES = [
    # (saved shape, saved spec, saved mesh, target mesh, target spec)
    ((8, 16), ("dp",), (("dp",), (4,)), ((1, 4), ("dp", "mp")), (None, "mp")),
    ((9, 16), ("dp",), (("dp",), (3,)), ((4,), ("dp",)), ("dp",)),
    ((8, 16), (), (("dp",), (4,)), ((4,), ("dp",)), ("dp",)),
    ((8, 16), ("dp", "mp"), (("dp", "mp"), (2, 2)), ((4,), ("dp",)),
     ("dp",)),
    ((8, 16), ("dp", "mp"), (("dp", "mp"), (2, 2)), ((1, 4), ("dp", "mp")),
     ("mp",)),
    ((8, 16), (None, "mp"), (("dp", "mp"), (2, 2)), ((2, 2), ("dp", "mp")),
     ()),
    ((8, 16), ("mp",), (("dp", "mp"), (2, 4)), ((2, 4), ("dp", "mp")),
     (None, "dp")),
    ((16, 8), (("dp", "mp"),), (("dp", "mp"), (2, 2)), ((4, 2),
                                                         ("dp", "mp")),
     ("mp",)),
]


@pytest.mark.parametrize("case", RESTORE_CASES,
                         ids=[str(i) for i in range(len(RESTORE_CASES))])
def test_plan_restore_spec_matches_reference(case):
    """The read spec of a restore (``tests/test_reshard.py::
    TestRestoreSpec`` and more): the reference's, on its device mesh and
    on the port's rank mesh."""
    from paddle_tpu_torch.distributed import ProcessMesh

    shape, spec, (names, sizes), (dshape, dnames), dst = case
    norm = port._norm_spec(spec, len(shape))
    lay_ref = ref.LeafLayout(shape, "float32", norm)
    lay = port.LeafLayout(shape, "float32", norm)
    n = int(np.prod(dshape))
    want = ref.plan_restore_spec(lay_ref, ref.MeshSpec(names, sizes),
                                 Mesh(DEVS[:n].reshape(dshape), dnames),
                                 P(*dst))
    mesh = ProcessMesh(np.arange(n).reshape(dshape), dim_names=list(dnames))
    got = port.plan_restore_spec(lay, port.MeshSpec(names, sizes), mesh, dst)
    assert port._norm_spec(got, len(shape)) == ref._norm_spec(want,
                                                              len(shape))
    assert port.plan_restore_spec(lay, None, mesh, dst) == dst


def test_layout_records_match_reference_documents(tmp_path):
    """``MeshSpec`` / ``LeafLayout`` documents are the reference's, round
    trip through JSON, and travel in the commit manifest (a manifest
    without them reads None, as a legacy one)."""
    ms, rms = port.MeshSpec(("dp", "mp"), (2, 4)), ref.MeshSpec(("dp", "mp"),
                                                                 (2, 4))
    assert ms.to_doc() == rms.to_doc()
    assert port.MeshSpec.from_doc(json.loads(json.dumps(ms.to_doc()))) == ms
    lay = port.LeafLayout((4, 8), "bfloat16", (("dp",), ("mp",)))
    rlay = ref.LeafLayout((4, 8), "bfloat16", (("dp",), ("mp",)))
    assert lay.to_doc() == rlay.to_doc()
    assert lay.local_bytes(ms.axis_sizes) == rlay.local_bytes(rms.axis_sizes)
    assert port.LeafLayout.from_doc(json.loads(json.dumps(lay.to_doc()))) \
        == lay
    rec = port.record_layouts({"m/w": lay, "step": port.LeafLayout(
        (), "int64", ())}, mesh=ms)
    manifest.write_manifest(str(tmp_path), meta={port.LAYOUT_KEY: rec})
    got_ms, leaves = port.read_layout_record(str(tmp_path))
    assert got_ms == ms and leaves["m/w"] == lay and leaves["step"].spec == ()
    # the reference reads the port's manifest
    rm, rleaves = ref.read_layout_record(str(tmp_path))
    assert rm.sizes == (2, 4) and rleaves["m/w"].spec == (("dp",), ("mp",))
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    ref_manifest.write_manifest(str(legacy))
    assert port.read_layout_record(str(legacy)) is None
    assert port.record_layouts({}) is None


def test_deadline_guard_raises_on_a_stall_and_is_silent_when_clean():
    collective.reset_counts()
    with port.deadline_guard("clean op", seconds=5.0):
        pass
    assert collective.counts["reshard_stalls"] == 0
    with pytest.raises(TimeoutError, match="stalled op"):
        with port.deadline_guard("stalled op", seconds=0.05):
            time.sleep(0.3)
    assert collective.counts["reshard_stalls"] == 1


def test_reshard_module_is_the_placement_api():
    """``paddle.distributed.reshard`` is callable as the placement API and
    is this module, as the reference's."""
    import paddle_tpu_torch.distributed as dist

    assert callable(port) and dist.reshard is port


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    out = tmp_path_factory.mktemp("reshard")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, [
        dict(name="reshard", kind="reshard")], {}, {})
    return [r["reshard"] for r in join_ranks(ctx, out)]


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_every_spec_pair_reshards_to_the_target_block(executed, dtype):
    """Every pair of specs on the 2 x 2 mesh: each rank's new block is the
    target's block of the source values, and the moved bytes and steps
    counted are the plan's."""
    n = len(RESHARD_SPECS)
    for r in range(WORLD):
        for i in range(n):
            for j in range(n):
                ok, moved, planned, steps, nsteps = \
                    executed[r]["pairs"][(dtype, i, j)]
                assert ok, (r, RESHARD_SPECS[i], RESHARD_SPECS[j])
                assert moved == planned and steps == nsteps, (i, j)


def test_dtensors_reshard_and_state_is_two_phase(executed):
    full = np.arange(int(np.prod(RESHARD_SHAPE)),
                     dtype=np.float32).reshape(RESHARD_SHAPE)
    for r in range(WORLD):
        e = executed[r]
        value, placements, local = e["dtensor"]
        np.testing.assert_array_equal(value, full)
        assert placements == "[Shard(dim=1), Shard(dim=1)]"
        assert local == (8, 4)
        np.testing.assert_array_equal(e["state"]["w"][0], full)
        assert e["state"]["w"][1] == "[Replicate(), Replicate()]"
        np.testing.assert_array_equal(e["state"]["b"][0], full[0])
        assert e["state"]["b"][1] == "[Shard(dim=0), Replicate()]"
        np.testing.assert_array_equal(e["state_kept"], full)
        value, local, transfer = e["cross"]
        np.testing.assert_array_equal(value, full)
        assert local == (2, 16) and transfer
        assert e["missing"] == "KeyError" and e["mismatch"] == "ValueError"
