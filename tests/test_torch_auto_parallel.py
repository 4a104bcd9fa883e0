"""The auto-parallel API of the PyTorch port (``ProcessMesh``, placements,
``shard_tensor`` / ``reshard``, ``parallelize``, ``to_distributed``,
``shard_dataloader``, ``Engine``) against the reference, at world size 4
on the CPU (gloo, one spawn running every job while this process runs the
reference on its 8-device mesh, as ``tests/test_parallelize.py`` and
``tests/test_auto_parallel_engine.py`` run it).

Held here:

- placements on a 2 x 2 mesh: ``shard_tensor`` / ``reshard`` through
  ``[Shard(0), Replicate()]`` -> ``[Replicate(), Shard(1)]`` ->
  ``[Shard(1), Shard(0)]``: the global values bit for bit and each rank's
  block the reference's device shard; a dim the axis does not divide
  stays replicated (the reference's ``_sanitize_spec``; its
  ``shard_tensor`` raises there), ``Partial`` keeps ``x``, ``reshard`` to
  ``Partial`` raises, a ``Shard`` of a parameter raises; the global mesh
  ``fleet.init`` sets;
- ``parallelize`` of the reference test's MLP at mp 2, with the
  sequence-parallel markers, at sharding levels 2 and 3, and of the tiny
  GPT (ColWise ``qkv_proj`` / ``fc_in``, RowWise ``out_proj`` /
  ``fc_out``, AdamW with the global-norm clip), each under a plain
  ``TrainStep``: losses within the reference test's ``rtol=2e-5,
  atol=1e-6`` of the reference's runs, each split parameter's
  ``split_axis`` the reference's ``dist_spec``; the refusals;
- ``to_distributed`` + ``shard_dataloader`` at dp 4: the parameters after
  3 SGD steps within 1e-6 of the reference's, the dp-mean of the ranks'
  losses its loss; a control without the data-axis mean misses;
- ``Engine`` fit / evaluate / predict / save / load against the
  reference's at dp 8 (``Engine.save`` writes the full arrays, which the
  reference's ``paddle.load`` reads).

The GPT plan names the port's (and the reference's) MLP layers
``mlp.fc_in`` / ``mlp.fc_out``.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as ref_dist
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed import mesh as ref_mesh
from paddle_tpu.distributed.auto_parallel import Engine as RefEngine
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep

from test_torch_fleet import _assert_params_close, _batches, _ref_model
from test_torch_fleet import _ref_train as _ref_gpt_train
from torch_port_utils import (AP_GPT_PLAN, AP_LR, AP_NETS, ap_embed_net,
                              ap_engine_net, ap_mlp, ap_plan, fleet_jobs,
                              join_ranks, no_mesh, numpy_state, spawn_ranks)

WORLD = 4
# tests/test_parallelize.py
RTOL, ATOL = 2e-5, 1e-6
PARAM_ATOL = 1e-6
ENGINE_EPOCHS = 1
MLP_PLAN = {"up": "col", "down": "row"}
SP_PLAN = {"up": ["col", "sp_begin"], "down": ["row", "sp_end"]}


def _data():
    rs = np.random.RandomState(0)
    return dict(
        placements=dict(x=np.arange(32, dtype=np.float32).reshape(8, 4),
                        odd=np.arange(5, dtype=np.float32)),
        mlp=dict(x=rs.randn(8, 16).astype("float32"),
                 y=rs.randn(8, 16).astype("float32")),
        sp=dict(x=rs.randn(4, 6, 16).astype("float32"),
                y=rs.randn(4, 6, 16).astype("float32")),
        to_dist=dict(x=rs.randn(3, 8, 16).astype("float32"),
                     y=rs.randn(3, 8, 16).astype("float32")),
        engine=dict(x=rs.randn(64, 8).astype("float32"),
                    y=rs.randn(64, 1).astype("float32")),
        embed=dict(x=rs.randint(0, 32, (8, 5)).astype("int64"),
                   y=rs.randn(8, 5, 8).astype("float32")),
        gpt=_batches()["gpt"])


def _t(v):
    return Tensor(jnp.asarray(v))


def _ref_net(make, state):
    m = make(paddle)
    m.set_state_dict({k: _t(v) for k, v in state.items()})
    return m


def _ref_mesh(names):
    return ref_dist.ProcessMesh(np.arange(8).reshape(4, 2),
                                dim_names=list(names))


def _ref_mlp(state, batch, steps, plan=None, level=0, axes=("dp", "mp"),
             net="mlp"):
    """The reference test's MLP (or ``AP_NETS[net]``) under ``TrainStep``
    (SGD), parallelized by ``plan`` / sharding ``level`` on its 8-device
    mesh when given."""
    with no_mesh():
        m = _ref_net(AP_NETS[net], state)
        opt = paddle.optimizer.SGD(learning_rate=AP_LR,
                                   parameters=m.parameters())
        config = {}
        if plan:
            config["mp_config"] = {"parallelize_plan": ap_plan(ref_dist,
                                                               plan)}
        if level:
            config["dp_config"] = {"sharding_level": level}
        if config:
            m, opt = ref_dist.parallelize(m, opt, _ref_mesh(axes), config)
        step = RefTrainStep(m, lambda mm, x, y: paddle.mean((mm(x) - y) ** 2),
                            opt)
        losses = [float(np.asarray(raw(step(_t(batch["x"]),
                                            _t(batch["y"])))))
                  for _ in range(steps)]
        return losses, {n: np.asarray(raw(p)) for n, p in
                        m.named_parameters()}


def _ref_gpt_specs(state):
    """The reference's ``dist_spec`` of each parameter the GPT plan
    places: ``{name: the dim it puts on mp, or None}``."""
    with no_mesh():
        m = _ref_model("gpt", state)
        ref_dist.parallelize(m, None, _ref_mesh(("dp", "mp")), {
            "mp_config": {"parallelize_plan": ap_plan(ref_dist,
                                                      AP_GPT_PLAN)}})
        out = {}
        for n, p in m.named_parameters():
            spec = tuple(getattr(p, "dist_spec", None) or ())
            out[n] = spec.index("mp") if "mp" in spec else None
        return out


def _ref_to_distributed(state, batch, steps):
    with no_mesh():
        m = _ref_net(ap_mlp, state)
        opt = paddle.optimizer.SGD(learning_rate=AP_LR,
                                   parameters=m.parameters())
        data = [(batch["x"][i], batch["y"][i]) for i in range(steps)]
        m, opt, dl = ref_dist.to_distributed(m, opt, data)
        step = RefTrainStep(m, lambda mm, x, y: paddle.mean((mm(x) - y) ** 2),
                            opt)
        losses = [float(np.asarray(raw(step(xb, yb)))) for xb, yb in dl]
        return losses, {n: np.asarray(raw(p)) for n, p in
                        m.named_parameters()}


def _ref_engine(state, batch, path):
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs["dp_degree"] = 8
        ref_fleet.init(is_collective=True, strategy=s)
        model = _ref_net(ap_engine_net, state)
        opt = paddle.optimizer.Adam(learning_rate=3e-2,
                                    parameters=model.parameters())
        engine = RefEngine(model, loss=paddle.nn.MSELoss(), optimizer=opt)
        X, Y = batch["x"], batch["y"]
        hist = engine.fit((X, Y), epochs=ENGINE_EPOCHS, batch_size=32,
                          verbose=0)
        ev = engine.evaluate((X, Y), batch_size=32)
        preds = engine.predict((X,), batch_size=32)
        engine.save(path)
        return dict(hist=hist["loss"], eval=ev["loss"],
                    preds=[np.asarray(raw(p)) for p in preds],
                    params={n: np.asarray(raw(p)) for n, p in
                            model.named_parameters()})


def _ref_placements(batch):
    mesh = ref_dist.ProcessMesh(np.arange(4).reshape(2, 2),
                                dim_names=["x", "y"])
    x = batch["x"]
    t = ref_dist.shard_tensor(x, mesh, [ref_dist.Shard(0),
                                        ref_dist.Replicate()])
    t2 = ref_dist.reshard(t, mesh, [ref_dist.Replicate(),
                                    ref_dist.Shard(1)])
    t3 = ref_dist.reshard(t2, mesh, [ref_dist.Shard(1), ref_dist.Shard(0)])
    part = ref_dist.shard_tensor(x, mesh, [ref_dist.Partial(),
                                           ref_dist.Replicate()])

    def shards(v):
        return {s.device.id: np.asarray(s.data)
                for s in raw(v).addressable_shards}

    odd_spec = ref_mesh._sanitize_spec(
        __import__("jax").sharding.PartitionSpec("x"), (5,), mesh.jax_mesh)
    return dict(t=t.numpy(), t2=t2.numpy(), t3=t3.numpy(),
                partial=part.numpy(), shards=[shards(v) for v in
                                              (t, t2, t3)],
                odd_spec=tuple(odd_spec))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _data()
    out = tmp_path_factory.mktemp("auto_parallel")
    with no_mesh():
        paddle.seed(42)
        states = {"mlp": numpy_state(ap_mlp(paddle)),
                  "embed": numpy_state(ap_embed_net(paddle)),
                  "engine": numpy_state(ap_engine_net(paddle)),
                  "gpt": numpy_state(_ref_model("gpt", None))}
    jobs = [
        dict(name="placements", kind="ap_placements", batch="placements"),
        dict(name="mlp_mp", kind="ap_mlp", model="mlp", batch="mlp",
             axes=("dp", "mp"), plan=MLP_PLAN, steps=4),
        dict(name="mlp_sp", kind="ap_mlp", model="mlp", batch="sp",
             axes=("dp", "mp"), plan=SP_PLAN, steps=3),
        dict(name="mlp_sh2", kind="ap_mlp", model="mlp", batch="mlp",
             axes=("dp", "sharding"), level=2, steps=4),
        dict(name="mlp_sh3", kind="ap_mlp", model="mlp", batch="mlp",
             axes=("dp", "sharding"), level=3, steps=4),
        dict(name="embed_row", kind="ap_mlp", net="embed", model="embed",
             batch="embed", axes=("dp", "mp"), plan={"0": "row"}, steps=3),
        dict(name="embed_col", kind="ap_mlp", net="embed", model="embed",
             batch="embed", axes=("dp", "mp"), plan={"0": "col_gather"},
             steps=3),
        dict(name="gpt", kind="ap_gpt", model="gpt", batch="gpt"),
        dict(name="to_dist", kind="ap_to_dist", model="mlp",
             batch="to_dist", steps=3),
        dict(name="engine", kind="ap_engine", model="engine",
             batch="engine", epochs=ENGINE_EPOCHS, path=str(out / "port")),
    ]
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, data)
    try:
        ref = dict(
            placements=_ref_placements(data["placements"]),
            mlp_mp=_ref_mlp(states["mlp"], data["mlp"], 4, plan=MLP_PLAN),
            mlp_sp=_ref_mlp(states["mlp"], data["sp"], 3, plan=SP_PLAN),
            embed=_ref_mlp(states["embed"], data["embed"], 3, net="embed"),
            gpt=_ref_gpt_train("gpt", states["gpt"], data["gpt"]),
            gpt_specs=_ref_gpt_specs(states["gpt"]),
            to_dist=_ref_to_distributed(states["mlp"], data["to_dist"], 3),
            engine=_ref_engine(states["engine"], data["engine"],
                               str(out / "ref")))
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, out=out)


def _all_ranks_equal(runs, job, key):
    got = runs["port"][0][job][key]
    for r in range(1, WORLD):
        assert runs["port"][r][job][key] == got, (job, key, r)
    return got


@pytest.mark.parametrize("name", ["t", "t2", "t3", "partial"])
def test_placed_global_values_bit_equal(runs, name):
    """Every rank's ``numpy()`` of a placed tensor is the reference's,
    bit for bit."""
    want = runs["ref"]["placements"][name]
    for r in range(WORLD):
        np.testing.assert_array_equal(runs["port"][r]["placements"][name],
                                      want)


@pytest.mark.parametrize("i,name", [(0, "t"), (1, "t2"), (2, "t3")])
def test_local_blocks_are_the_reference_device_shards(runs, i, name):
    """Rank r's block is the reference's shard on device r of the same
    2 x 2 mesh."""
    shards = runs["ref"]["placements"]["shards"][i]
    for r in range(WORLD):
        np.testing.assert_array_equal(
            runs["port"][r]["placements"][f"{name}_local"], shards[r])


def test_placement_rules_and_refusals(runs):
    p = runs["port"][0]["placements"]
    x = _data()["placements"]["x"]
    # rule 1: the indivisible dim stays replicated, as _sanitize_spec
    assert runs["ref"]["placements"]["odd_spec"] == ()
    assert p["odd_local"] == (5,)
    assert p["odd_placements"] == "[Replicate(), Replicate()]"
    np.testing.assert_array_equal(p["odd"], np.arange(5, dtype=np.float32))
    # rule 2: Partial keeps x (coordinate 0 holds it, the others zeros)
    np.testing.assert_array_equal(p["partial_back"], x)
    held = [runs["port"][r]["placements"]["partial_local"].sum()
            for r in range(WORLD)]
    assert held == [x.sum(), x.sum(), 0.0, 0.0]
    assert p["to_partial"] == "NotImplementedError"
    assert p["param_shard"] == "NotImplementedError"
    assert p["param_replicate"] == (4, 4)
    assert p["eq"] == [True, True, False, "Shard(dim=1)", "Partial(sum)"]
    np.testing.assert_array_equal(p["fn"], np.ones((4, 2), np.float32))
    np.testing.assert_array_equal(p["con"], x)
    assert p["con_placements"] == "[Replicate(), Shard(dim=1)]"
    assert p["plain_same"]
    # shard_layer visits every sublayer, its layer takes placed inputs
    # (its rows), and a shard_fn splitting a weight raises
    assert p["shard_layer"] == ([""], (4, 3), "Tensor",
                                "NotImplementedError")
    # input_keys: only "a" is split over x
    assert p["loader"] == ((4, 4), (8, 4))


def test_fleet_init_sets_the_hybrid_mesh(runs):
    """``tests/test_auto_parallel_engine.py::test_shard_tensor_and_reshard``
    at dp 2 x mp 2: the global mesh names the hybrid axes; a batch placed
    on dp and resharded replicated keeps its values."""
    p = runs["port"][0]["placements"]
    assert p["fleet_mesh"] == (["dp", "pp", "sharding", "sep", "mp"],
                               [2, 1, 1, 1, 2])
    x = _data()["placements"]["x"]
    got, rows, back = p["fleet_shard"]
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(back, x)
    assert rows == (4, 4)


@pytest.mark.parametrize("job,ref", [("mlp_mp", "mlp_mp"),
                                     ("mlp_sp", "mlp_sp"),
                                     ("mlp_sh2", "mlp_mp"),
                                     ("mlp_sh3", "mlp_mp")])
def test_parallelize_loss_parity(runs, job, ref):
    """``tests/test_parallelize.py``'s loss parity: the port's
    parallelized MLP under a plain ``TrainStep`` against the reference's
    parallelized run (which its test holds equal to its plain run; the
    sharding levels against its mp run: one global program either
    way)."""
    got = _all_ranks_equal(runs, job, "losses")
    want = runs["ref"][ref][0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = runs["port"][0][job]["full"]
    for n, w in runs["ref"][ref][1].items():
        np.testing.assert_allclose(full[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("job", ["embed_row", "embed_col"])
def test_parallelize_embedding_plans(runs, job):
    """An Embedding under RowWise (vocab-parallel: ids outside a rank's
    rows look up 0, the rows all-reduced) and ColWise with
    ``gather_output`` (the embedding dim split) trains as the reference's
    whole model."""
    got = _all_ranks_equal(runs, job, "losses")
    want_losses, want = runs["ref"]["embed"]
    np.testing.assert_allclose(got, want_losses, rtol=RTOL, atol=ATOL)
    full = runs["port"][0][job]["full"]
    for n, w in want.items():
        np.testing.assert_allclose(full[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    axis = 0 if job == "embed_row" else 1
    assert runs["port"][0][job]["split"] == {"0.weight": axis}


def test_parallelize_splits_as_the_reference_places(runs):
    """Each split parameter's ``split_axis`` is the dim the reference's
    ``dist_spec`` puts on mp; a bias the degree divides follows the
    columns, a RowWise bias stays whole."""
    assert runs["port"][0]["mlp_mp"]["split"] == {
        "up.weight": 1, "up.bias": 0, "down.weight": 0}
    assert runs["port"][0]["mlp_mp"]["local"]["down.bias"] == (16,)
    got = runs["port"][0]["gpt"]["split"]
    want = {n: d for n, d in runs["ref"]["gpt_specs"].items()
            if d is not None and any(k in n for k in (
                "qkv_proj", "out_proj", "fc_in", "fc_out"))}
    assert got == want
    assert len(got) == 2 * 6  # 2 layers x (3 weights + 3 split biases)


def test_parallelize_gpt_matches_reference(runs):
    """The tiny GPT at dp 2 x mp 2 (local heads 4 / 2) under AdamW with the
    global-norm clip against the reference's ``TrainStep``."""
    got = runs["port"][0]["gpt"]
    want_losses, want = runs["ref"]["gpt"]
    assert got["heads"] == 2
    np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL,
                               atol=ATOL)
    _assert_params_close(got["full"], want)
    for r in range(1, WORLD):
        assert runs["port"][r]["gpt"]["losses"] == got["losses"]


def test_parallelize_refusals(runs):
    """A plan that cuts a head, the reference's ``ValueError`` s and its
    ``pp_config`` refusal, and a model whose output is a split ColWise
    output."""
    assert runs["port"][0]["gpt"]["errors"] == dict(
        cut_head="NotImplementedError", no_match="ValueError",
        pp="NotImplementedError", no_mp="ValueError",
        no_sharding="ValueError", split_output="NotImplementedError")


def test_to_distributed_trains_as_the_reference(runs):
    """``to_distributed`` at dp 4 with the sharded loader: each rank trains
    on its 2 of 8 rows; the parameters after 3 SGD steps are the
    reference's, the ranks' mean loss its loss. Without the data-axis
    mean (the control) the parameters miss."""
    want_losses, want = runs["ref"]["to_dist"]
    ranks = [runs["port"][r]["to_dist"] for r in range(WORLD)]
    assert ranks[0]["rows"] == (2, 16)
    mean = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(mean, want_losses, rtol=RTOL, atol=ATOL)
    for r in ranks:
        for n, w in want.items():
            np.testing.assert_allclose(r["params"][n], w, rtol=0,
                                       atol=PARAM_ATOL, err_msg=n)
    miss = max(np.abs(ranks[0]["control"][n] - w).max()
               for n, w in want.items())
    assert miss > 100 * PARAM_ATOL


def test_engine_fit_evaluate_predict_save_load(runs):
    """``Engine`` at dp 4 against the reference's at dp 8: the history,
    the evaluation, the predictions; ``save`` writes the full arrays (the
    reference's ``load`` reads them) and ``load`` restores them."""
    got = runs["port"][0]["engine"]
    want = runs["ref"]["engine"]
    np.testing.assert_allclose(got["hist"], want["hist"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=RTOL,
                               atol=ATOL)
    assert len(got["preds"]) == len(want["preds"]) == 2
    for g, w in zip(got["preds"], want["preds"]):
        assert g.shape == w.shape == (32, 1)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for n, w in want["params"].items():
        np.testing.assert_allclose(got["params"][n], w, rtol=RTOL,
                                   atol=ATOL, err_msg=n)
        np.testing.assert_array_equal(got["loaded"][n], got["params"][n])
    assert got["moments"] == 4  # the .pdopt's Adam state, every parameter
    saved = paddle.load(str(runs["out"] / "port.pdparams"))
    for n, v in got["params"].items():
        np.testing.assert_array_equal(np.asarray(raw(saved[n])), v)
    for r in range(1, WORLD):
        assert runs["port"][r]["engine"]["hist"] == got["hist"]


def test_shard_dataloader_errors():
    """The reference's ``ValueError`` s of ``shard_dataloader``
    (``auto_parallel/__init__.py:185-192``); no process group needed."""
    from paddle_tpu_torch import distributed as dist

    mesh = dist.ProcessMesh(np.arange(4).reshape(2, 2),
                            dim_names=["dp", "mp"])
    with pytest.raises(ValueError):
        dist.shard_dataloader([], mesh, shard_dims=5)
    with pytest.raises(ValueError):
        dist.shard_dataloader([], mesh, shard_dims="zz")
    loader = dist.shard_dataloader([1, 2], [mesh, mesh], shard_dims=[1])
    assert loader._dim == "mp" and len(loader) == 2


def test_mesh_helpers_without_a_process_group():
    """``build_mesh`` / the global mesh / ``sharding_constraint`` on a
    plain tensor (the identity with no mesh, as the reference's)."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import mesh as pmesh

    m = dist.build_mesh((2, 2), ("dp", "mp"), devices=[0, 1, 2, 3])
    assert m.dim_names == ["dp", "mp"] and m.shape == [2, 2]
    assert m.coordinate(3) == (1, 1) and m.coordinate(9) is None
    assert m == dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["a", "b"])
    with pytest.raises(ValueError):
        dist.build_mesh((2, 3), ("dp", "mp"), devices=[0, 1, 2, 3])
    with pytest.raises(NotImplementedError):
        pmesh.build_hybrid_mesh((4,), ("dp",), devices=range(4),
                                num_slices=2)
    x = torch.ones(3)
    assert dist.sharding_constraint(x, ("dp",)) is x
    with dist.global_mesh(m):
        assert dist.get_global_mesh() is m and dist.get_mesh() is m
        assert pmesh.mesh_axis_size("mp") == 2
        assert pmesh.mesh_axis_size("pp") == 1
    assert dist.get_global_mesh() is None
