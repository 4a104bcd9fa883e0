"""The quantized gradient wire of the PyTorch port (``grad_comm`` bf16 /
int8 with error feedback, ``collective.psum_quantized`` /
``all_gather_quantized``) against the reference.

The quantizers and layouts run in this process against the reference's
functions on the same arrays (bit-equal: elementwise f32 arithmetic on
both sides). One spawn of 4 gloo ranks runs the quantized collectives
(against the reference's on a 4-device CPU mesh) and
``tests/test_grad_comm.py``'s ``_Net`` trained 3 AdamW steps at dp 4 and
at dp 2 x sharding 2 (stage 2) with a bf16 and an int8 + error-feedback
wire, against the reference's DistTrainStep at the same config under
that test's tolerance (:304, :311); the bytes each rank puts on the wire
are the arithmetic of its buckets."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import collective as ref_C
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed import grad_comm as ref_gc
from paddle_tpu.framework.core import Tensor
from paddle_tpu_torch.distributed import grad_comm as gc

from torch_port_utils import (fleet_jobs, join_ranks, no_mesh, numpy_state,
                              spawn_ranks, wire_ids, wire_loss, wire_net,
                              wire_strategy)

WORLD = 4
# tests/test_grad_comm.py::test_bf16_wire_close_to_f32 (:304)
WIRE_ATOL = 5e-3

CONFIGS = {"dp4": dict(dp=4), "dp2_sh2": dict(dp=2, sharding=2, stage=2)}
WIRES = {"f32": {}, "bf16": dict(wire="bf16"),
         "int8_ef": dict(wire="int8", ef=True)}


def _arrays(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_quantize_roundtrip_bit_equal(wire):
    v = _arrays(3, 64) * 3.0
    got = gc.quantize_roundtrip(torch.from_numpy(v), wire).numpy()
    want = np.asarray(ref_gc.quantize_roundtrip(jnp.asarray(v), wire))
    np.testing.assert_array_equal(got, want)
    z = gc.quantize_roundtrip(torch.zeros(4), wire).numpy()
    np.testing.assert_array_equal(z, np.zeros(4, np.float32))


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_quantize_with_feedback_bit_equal(wire):
    v, res = _arrays(4, 32), _arrays(5, 32) * 0.01
    q, r = gc.quantize_with_feedback(torch.from_numpy(v),
                                     torch.from_numpy(res), wire)
    rq, rr = ref_gc.quantize_with_feedback(jnp.asarray(v), jnp.asarray(res),
                                           wire)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(rr))
    # sent + carried == intended
    np.testing.assert_allclose((q + r).numpy(), v + res, atol=1e-6)


def test_shard_major_layout_matches_reference():
    leaves = [_arrays(2, (4, 3)), _arrays(6, (8,))]
    lay = gc.make_shard_layout([0, 1], [l.shape for l in leaves], [0, 0], 2)
    ref = ref_gc.make_shard_layout([0, 1], [l.shape for l in leaves],
                                   [0, 0], 2)
    assert (lay.block, lay.total, lay.shard_sizes) == (
        ref.block, ref.total, ref.shard_sizes)
    flat = gc.pack_shard_major([torch.from_numpy(l) for l in leaves], lay)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(ref_gc.pack_shard_major(
            [jnp.asarray(l) for l in leaves], ref)))
    for (i, v), (j, w) in zip(gc.unpack_shard_block(flat[:lay.block], lay),
                              ref_gc.unpack_shard_block(
                                  jnp.asarray(flat[:lay.block].numpy()),
                                  ref)):
        assert i == j
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))
    for i, v in gc.unpack_gathered(flat, lay):
        np.testing.assert_array_equal(v.numpy(), leaves[i])
    with pytest.raises(ValueError, match="not divisible"):
        gc.make_shard_layout([0], [(5, 3)], [0], 2)


def _ref_quantized():
    """The reference's psum_quantized and all_gather_quantized over a
    4-device axis on the spawn's inputs, value and gradient."""
    from jax.experimental.shard_map import shard_map

    inp = _collective_inputs()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("x",))
    out = {}
    for wire in ("bf16", "int8"):
        def ps(v):
            return ref_C.psum_quantized(v[0], "x", wire, via="gather")[None]

        val = shard_map(ps, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                        check_rep=False)(jnp.asarray(inp["psum"]))
        grad = shard_map(jax.grad(lambda v: jnp.sum(ps(v))), mesh=mesh,
                         in_specs=(P("x"),), out_specs=P("x"),
                         check_rep=False)(jnp.asarray(inp["psum"]))

        def ag(v):
            return ref_C.all_gather_quantized(
                v, "x", wire_dtype=wire, segments=(5, 3), grad_wire="int8")

        gval = shard_map(ag, mesh=mesh, in_specs=(P("x"),), out_specs=P(),
                         check_rep=False)(jnp.asarray(inp["gather"]).reshape(
                             -1))
        ggrad = shard_map(jax.grad(lambda v: jnp.sum(ag(v))), mesh=mesh,
                          in_specs=(P("x"),), out_specs=P("x"),
                          check_rep=False)(jnp.asarray(
                              inp["gather"]).reshape(-1))
        out[wire] = (np.asarray(val), np.asarray(grad), np.asarray(gval),
                     np.asarray(ggrad).reshape(WORLD, -1))
    return out


def _collective_inputs():
    rng = np.random.RandomState(8)
    return {"psum": rng.standard_normal((WORLD, 5)).astype(np.float32),
            "gather": rng.standard_normal((WORLD, 8)).astype(np.float32)}


def _ref_wire(job, state, ids):
    """The reference's DistTrainStep on ``_Net`` at the job's config and
    wire: its 3 losses."""
    with no_mesh():
        ref_fleet.init(is_collective=True,
                       strategy=wire_strategy(job, ref_fleet))
        net = wire_net(paddle)
        net.set_state_dict({k: Tensor(jnp.asarray(v))
                            for k, v in state.items()})
        opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=net.parameters())
        ref_fleet.distributed_model(net)
        opt = ref_fleet.distributed_optimizer(opt)
        step = ref_fleet.DistTrainStep(net, wire_loss(paddle.nn.functional),
                                       opt)
        losses = [float(step(Tensor(jnp.asarray(ids)),
                             Tensor(jnp.asarray(ids)))) for _ in range(3)]
        plan = step._grad_comm_plan
        return losses, (None if plan is None
                        else (plan.bytes_wire, plan.bytes_f32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.delenv("PADDLE_TPU_GRAD_COMM", raising=False)
    with no_mesh():
        paddle.seed(0)
        state = numpy_state(wire_net(paddle))
    ids = wire_ids()
    jobs = [dict(name=f"{c}_{w}", kind="wire", **ckw, **wkw)
            for c, ckw in CONFIGS.items() for w, wkw in WIRES.items()]
    jobs += [dict(name="dp4_int8_ef_eager", kind="wire", dp=4, wire="int8",
                  ef=True, eager=True),
             dict(name="dp2_mp2_bf16", kind="wire", dp=2, mp=2,
                  wire="bf16"),
             dict(name="collectives", kind="quantized", batch="coll")]
    out = tmp_path_factory.mktemp("wire")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, {None: state},
                      {None: ids, "coll": _collective_inputs()})
    try:
        ref = {f"{c}_{w}": _ref_wire(dict(ckw, **wkw), state, ids)
               for c, ckw in CONFIGS.items() for w, wkw in WIRES.items()}
        ref["collectives"] = _ref_quantized()
    finally:
        port = join_ranks(ctx, out)
    return port, ref


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_quantized_collectives_match_reference(runs, wire):
    port, ref = runs
    val, grad, gval, ggrad = ref["collectives"][wire]
    for r in range(WORLD):
        got = port[r]["collectives"]
        s, sg = got[f"psum_{wire}"]
        np.testing.assert_allclose(s, val[r], atol=1e-6)
        np.testing.assert_allclose(sg, grad[r], atol=1e-6)
        a, ag = got[f"gather_{wire}"]
        np.testing.assert_allclose(a, gval, atol=1e-6)
        np.testing.assert_allclose(ag, ggrad[r], atol=1e-6)
        assert "segments sum" in got["bad_segments"]


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_wire_trajectory_matches_reference(runs, config, wire):
    """The losses against the reference's at the same config and wire,
    and against the port's f32 exchange, within the reference test's
    tolerance; every rank reports the same."""
    port, ref = runs
    name = f"{config}_{wire}"
    got = port[0][name]
    want, _ = ref[name]
    np.testing.assert_allclose(got["losses"], want, atol=WIRE_ATOL, rtol=0)
    np.testing.assert_allclose(got["losses"],
                               port[0][f"{config}_f32"]["losses"],
                               atol=WIRE_ATOL, rtol=0)
    assert got["losses"][-1] < got["losses"][0]
    for r in range(1, WORLD):
        assert port[r][name]["losses"] == got["losses"]
        for n, v in got["full"].items():
            np.testing.assert_array_equal(port[r][name]["full"][n], v)


@pytest.mark.parametrize("wire", ["bf16", "int8_ef"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_wire_bytes_are_the_arithmetic(runs, config, wire):
    """A step puts each bucket on the wire once in the wire dtype: bf16
    half the f32 bytes, int8 a quarter plus one f32 scale a bucket; the
    reference's plan prices the same payload (its ``bytes_wire``, without
    the scales). With error feedback the residuals (one f32 buffer a
    bucket) are in the optimizer's state_dict."""
    port, ref = runs
    got = port[0][f"{config}_{wire}"]
    w = got["wire"]
    n = got["n_params"]
    assert w["n_elems"] == n and w["bytes_f32"] == 4 * n
    if wire == "bf16":
        assert w["bytes_wire"] == 2 * n
    else:
        assert w["bytes_wire"] == n + 4 * w["buckets"]
        assert len(got["residuals"]) == w["buckets"]
    assert w["bytes_wire"] < w["bytes_f32"]
    assert got["counts"]["grad_wire_bytes"] == 3 * w["bytes_wire"]
    assert got["counts"]["grad_wire_f32_bytes"] == 3 * w["bytes_f32"]
    ref_wire, ref_f32 = ref[f"{config}_{wire}"][1]
    assert ref_f32 == w["bytes_f32"]
    assert ref_wire == {"bf16": 2, "int8_ef": 1}[wire] * n
    if config == "dp2_sh2":  # ZeRO-2: the shard-major buckets
        assert w["zero_buckets"] >= 1
    # the f32 exchange keeps its all-reduce and puts nothing on the wire
    assert "grad_wire_bytes" not in port[0][f"{config}_f32"]["counts"]


def test_eager_loop_takes_the_wire(runs):
    """``fused_allreduce_gradients`` exchanges through the same wire: the
    ranks' mean loss follows DistTrainStep's."""
    port, _ = runs
    res = [port[r]["dp4_int8_ef_eager"] for r in range(WORLD)]
    np.testing.assert_allclose(np.mean([r["losses"] for r in res], 0),
                               port[0]["dp4_int8_ef"]["losses"],
                               atol=WIRE_ATOL, rtol=0)
    assert res[0]["counts"]["grad_wire_bytes"] == \
        3 * res[0]["wire"]["bytes_wire"]


def test_wire_falls_back_where_the_reference_does(runs):
    """With mp > 1 the reference keeps its exact exchange; so does the
    port, and it says so once."""
    port, _ = runs
    got = port[0]["dp2_mp2_bf16"]
    assert got["wire"] is None
    assert "grad_wire_bytes" not in got["counts"]
    assert any("model, pipe or sep" in w for w in got["warnings"])
