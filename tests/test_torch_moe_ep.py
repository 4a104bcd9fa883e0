"""MoE over a split batch and expert parallelism of the PyTorch port
against the reference, at world size 4 on the CPU (gloo, one spawn
running every job, ``file://`` rendezvous, joined under its own time
limit).

The reference's ``_run_moe`` network (``tests/test_loss_parity.py``
:175-206; the gate without noise: both sides in eval mode) trains 3 AdamW
steps through ``fleet.DistTrainStep`` on the same full weights and global
batches as the reference's ``TrainStep`` and its ``DistTrainStep`` at the
same degrees (its dp filling 8 devices):

- at data degree 2 (dp 2 x mp 2, the mp axis idle): the gate takes the
  capacity, the queue positions and the aux loss over the global batch
  (before the repair each rank gated its own rows and the losses parted);
  the dropless path's aux loss likewise;
- with the experts split (the expert axis the first of sharding, dp, sep
  above degree 1): sharding 4 (ZeRO-1), dp 2 x sharding 2, dp 4 (8
  experts, 2 a rank), and dp 2 x sep 2 (the sequence split too); each rank
  holds its ``E / n`` experts, the state interchanges with the
  reference's full arrays both ways;
- ``MoENet`` of ``examples/train_moe.py`` at dp 2 x sharding 2;
- with the experts split over an axis the batch is not split over: at
  3 rows, which neither dp 4 nor dp 2 divides, ``DistTrainStep`` leaves
  the rows whole on every data rank (dp 4; dp 2 x sep 2, the sequence
  still split), so every rank of the expert group holds the same tokens
  and no exchange runs: losses, trajectories and the first step's
  gradients against the reference's ``TrainStep`` and eager gradients on
  the whole batch;
- outside ``DistTrainStep`` (an eager step on each rank's own rows), with
  the experts split over sharding 4 and dp 2 x sharding 2: each rank's
  loss is the reference's on its rows alone (upstream Paddle's per-rank
  semantics) and the averaged gradients the mean of the reference's.

``global_scatter`` / ``global_gather`` are held to their layouts, round
trips, gradients and byte counts, dense and with upstream's counts."""
import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep

from torch_port_utils import (FLEET_LR, MOE_VOCAB, fleet_adamw, fleet_jobs,
                              join_ranks, moe_example_net, moe_net, no_mesh,
                              numpy_state, spawn_ranks)

WORLD = 4
STEPS = 3
E = 8
# f32 through the gate, two expert matmuls and the CE on both sides, as
# test_torch_fleet.py
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * FLEET_LR * STEPS
MAX_NOISY_FRACTION = 0.01
EXPERTS = ("moe.w_in", "moe.b_in", "moe.w_out", "moe.b_out")

# gradients: a few ulps of each parameter's largest gradient, as
# test_torch_moe.py
GRAD_TOL = 1e-5
EAGER_CONFIGS = {"sh4": dict(dp=1, sharding=4), "dp2_sh2": dict(dp=2,
                                                                sharding=2)}

# port degrees, and the reference's (its dp fills 8 devices); ``ep`` the
# expert degree each port rank splits its experts by
CONFIGS = {
    "dp2_mp2": dict(port=dict(dp=2, mp=2), ref=dict(dp_degree=2), ep=2),
    "sh4": dict(port=dict(dp=1, sharding=4), ref=dict(sharding_degree=4),
                ep=4),
    "dp2_sh2": dict(port=dict(dp=2, sharding=2),
                    ref=dict(sharding_degree=2), ep=2),
    "dp4": dict(port=dict(dp=4), ref=dict(dp_degree=4), ep=4),
    "dp2_sep2": dict(port=dict(dp=2, sep=2),
                     ref=dict(dp_degree=2, sep_degree=2), ep=2),
}

# the expert axis over ranks that hold the same tokens (3 rows: no data
# degree here divides them)
ROWS_CONFIGS = {"dp4_rows3": dict(dp=4), "dp2_sep2_rows3": dict(dp=2, sep=2)}
ROWS = 3


def _rows_batches():
    rng = np.random.default_rng(43)
    return [rng.integers(0, MOE_VOCAB, (ROWS, 16)) for _ in range(STEPS)]


def _batches():
    """The reference's ``_data()`` draws (8 x 16 ids, ids as labels)."""
    rng = np.random.default_rng(42)
    return [rng.integers(0, MOE_VOCAB, (8, 16)) for _ in range(STEPS)]


def _example_batches():
    """``examples/train_moe.py``'s batches: x [16, 8, 16], 4 classes."""
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for _ in range(STEPS):
        x = rng.standard_normal((16, 8, 16)).astype("float32")
        y = ((x.mean((1, 2)) > 0).astype("int64") * 2
             + (x.std((1, 2)) > 1).astype("int64"))
        xs.append(x)
        ys.append(y)
    return dict(x=xs, y=ys)


def _exchange_batches(n=4, el=2, h=3, c=2):
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((n, n * el, c, h)).astype(np.float32)
    counts = rng.integers(0, 4, (n, n * el))
    rows = [rng.standard_normal((int(counts[r].sum()), h)).astype(np.float32)
            for r in range(n)]
    return dict(dense=dense, counts=counts, rows=rows)


def _ref_net(drop_tokens=True):
    paddle.seed(55)
    m = moe_net(paddle, drop_tokens=drop_tokens)
    m.eval()
    return m


def _ref_example():
    paddle.seed(3)
    m, loss_fn = moe_example_net(paddle)
    m.eval()
    return m, loss_fn


def _moe_loss(m, ids, labels):
    return m(ids, labels=labels)


def _args(batch, i):
    x = batch["x"][i]
    y = batch.get("y", batch["x"])[i]
    conv = (lambda a: a.astype(np.int32)) if x.dtype.kind == "i" else \
        (lambda a: a)
    return Tensor(jnp.asarray(conv(x))), Tensor(jnp.asarray(
        y.astype(np.int32)))


def _trajectory(model, loss_fn, batch, degrees=None):
    """The reference's losses and final parameters: its TrainStep, or its
    DistTrainStep at ``degrees``."""
    with no_mesh():
        if degrees is not None:
            s = ref_fleet.DistributedStrategy()
            s.hybrid_configs.update(dict(dict(dp_degree=-1), **degrees))
            ref_fleet.init(is_collective=True, strategy=s)
        net, fn = model()
        opt = fleet_adamw(net.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        if degrees is None:
            step = RefTrainStep(net, fn or loss_fn, opt)
        else:
            net = ref_fleet.distributed_model(net)
            step = ref_fleet.DistTrainStep(
                net, fn or loss_fn, ref_fleet.distributed_optimizer(opt))
        losses = [float(np.asarray(raw(step(*_args(batch, i)))))
                  for i in range(STEPS)]
        return losses, {n: np.asarray(raw(p))
                        for n, p in net.named_parameters()}


def _eager(ids, n):
    """The reference's loss and gradients on each of the ``n`` row blocks
    of ``ids`` alone, at degree 1."""
    b = ids.shape[0] // n
    out = []
    with no_mesh():
        for r in range(n):
            net = _ref_net()
            x = Tensor(jnp.asarray(ids[r * b:(r + 1) * b].astype(np.int32)))
            loss = _moe_loss(net, x, x)
            loss.backward()
            out.append((float(np.asarray(raw(loss))),
                        {k: np.asarray(raw(p.grad))
                         for k, p in net.named_parameters()}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ids = _batches()
    moe_batch = dict(x=ids)
    example = _example_batches()
    with no_mesh():
        states = {"moe": numpy_state(_ref_net()),
                  "moe_dropless": numpy_state(_ref_net(False)),
                  "example": numpy_state(_ref_example()[0])}
    jobs = [dict(name=c, kind="moe", model="moe", batch="moe", **cfg["port"])
            for c, cfg in CONFIGS.items()]
    jobs += [dict(name="dropless_dp2_mp2", kind="moe", model="moe_dropless",
                  batch="moe", drop_tokens=False, dp=2, mp=2),
             dict(name="example_dp2_sh2", kind="moe", model="example",
                  batch="example", net="example", dp=2, sharding=2),
             *(dict(name=f"eager_{c}", kind="moe_eager", model="moe",
                    batch="moe", **deg) for c, deg in EAGER_CONFIGS.items()),
             dict(name="exchange_sh4", kind="exchange", batch="exchange",
                  dp=1, sharding=4),
             dict(name="exchange_dp2_sh2", kind="exchange",
                  batch="exchange2", dp=2, sharding=2),
             *(dict(name=c, kind="moe", model="moe", batch="rows",
                    grads=True, **deg) for c, deg in ROWS_CONFIGS.items())]
    rows_ids = _rows_batches()
    batches = dict(moe=moe_batch, example=example, rows=dict(x=rows_ids),
                   exchange=_exchange_batches(),
                   exchange2=_exchange_batches(n=2))
    out = tmp_path_factory.mktemp("moe_ep")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, batches)
    try:
        ref = {"train": _trajectory(lambda: (_ref_net(), None), _moe_loss,
                                    moe_batch),
               "dropless": _trajectory(lambda: (_ref_net(False), None),
                                       _moe_loss, moe_batch),
               "example": _trajectory(_ref_example, None, example)}
        ref["eager"] = _eager(ids[0], WORLD)
        ref["rows"] = _trajectory(lambda: (_ref_net(), None), _moe_loss,
                                  dict(x=rows_ids))
        ref["rows_grads"] = _eager(rows_ids[0], 1)[0][1]
        for c, cfg in CONFIGS.items():
            ref[c] = _trajectory(lambda: (_ref_net(), None), _moe_loss,
                                 moe_batch, cfg["ref"])
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, states=states, batches=batches)


def _assert_params_close(got, want):
    noisy = total = 0
    for n, w in want.items():
        d = np.abs(got[n] - w)
        assert d.max() <= NOISE_BOUND, (n, d.max())
        noisy += int((d > PARAM_ATOL).sum())
        total += d.size
    assert noisy <= MAX_NOISY_FRACTION * total, (noisy, total)


def _losses(runs, name):
    losses = runs["port"][0][name]["losses"]
    for r in range(WORLD):
        assert runs["port"][r][name]["losses"] == losses
    return losses


@pytest.mark.parametrize("against", ["train", "dist"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_capacity_moe_matches_reference(runs, config, against):
    losses = _losses(runs, config)
    want, final = runs["ref"]["train" if against == "train" else config]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    _assert_params_close(runs["port"][0][config]["full"], final)


def test_gate_over_split_batch_matches_reference_dist_train_step(runs):
    """The repair: at data degree 2 the capacity, the queue positions and
    the aux loss are those of the global batch, as the reference's."""
    losses = _losses(runs, "dp2_mp2")
    want, _ = runs["ref"]["dp2_mp2"]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_dropless_aux_loss_over_split_batch(runs):
    losses = _losses(runs, "dropless_dp2_mp2")
    want, final = runs["ref"]["dropless"]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _assert_params_close(runs["port"][0]["dropless_dp2_mp2"]["full"], final)
    # the dropless path keeps every expert on every rank
    assert runs["port"][0]["dropless_dp2_mp2"]["local"][
        "moe.w_in"].shape[0] == E


@pytest.mark.parametrize("config", list(CONFIGS))
def test_each_rank_holds_its_experts(runs, config):
    """Each rank holds ``E / n`` experts: the reference's full arrays cut
    at its expert rank when loaded, gathered back whole by ``state_dict``
    (written back, the slices stay), the slices its own under ZeRO."""
    ep = CONFIGS[config]["ep"]
    el = E // ep
    state = runs["states"]["moe"]
    for r in range(WORLD):
        res = runs["port"][r][config]
        e = res["expert_rank"]
        for n in EXPERTS:
            assert res["local"][n].shape[0] == el, (r, n)
            np.testing.assert_array_equal(res["loaded"][n],
                                          state[n][e * el:(e + 1) * el])
            np.testing.assert_array_equal(res["full"][n][e * el:(e + 1) * el],
                                          res["local"][n])
            assert res["full"][n].shape[0] == E
        assert res["round_trip"]
        assert res["expert_axis"] == {"sh4": "sharding", "dp2_sh2": "sharding",
                                      "dp2_sep2": "data"}.get(config, "data")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_exchange_bytes_follow_the_expert_buffer(runs, config):
    """Each step sends the rank's ``[E, C, h]`` buffer out and back once a
    way, and the backward the same again: C = ceil(k * 1.25 * G / E)."""
    g = 8 * 16
    cap = int(np.ceil(2 * 1.25 * g / E))
    per_call = E * cap * 32 * 4
    for r in range(WORLD):
        counts = runs["port"][r][config]["counts"]
        for op in ("global_scatter", "global_gather"):
            assert counts[f"{op}_bytes"] == 2 * per_call * STEPS, (r, counts)


def test_example_moe_net_matches_reference(runs):
    losses = _losses(runs, "example_dp2_sh2")
    want, final = runs["ref"]["example"]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _assert_params_close(runs["port"][0]["example_dp2_sh2"]["full"], final)


@pytest.mark.parametrize("config", list(EAGER_CONFIGS))
def test_ep_outside_dist_train_step_on_each_ranks_rows(runs, config):
    """The eager loop on each rank's own rows with the experts split: the
    exchange brings each owner every rank's block and sends each output
    back to its source, so rank r's loss is the reference's on its rows
    alone; ``fused_allreduce_gradients`` leaves the mean of the
    reference's gradients over the ranks (expert slices cut at the rank's
    experts)."""
    ref = runs["ref"]["eager"]
    b = 8 // WORLD
    mean = {k: np.mean([g[k] for _, g in ref], axis=0) for k in ref[0][1]}
    el = E // EAGER_CONFIGS[config]["sharding"]
    for r in range(WORLD):
        res = runs["port"][r][f"eager_{config}"]
        lo = res["rows"][0]
        np.testing.assert_allclose(res["loss"], ref[lo // b][0],
                                   rtol=LOSS_RTOL)
        e = res["expert_rank"]
        assert sorted(res["grads"]) == sorted(mean)
        for k, g in mean.items():
            want = g[e * el:(e + 1) * el] if k in EXPERTS else g
            scale = np.abs(want).max()
            assert scale > 0, (r, k)
            err = np.abs(res["grads"][k] - want).max()
            assert err <= GRAD_TOL * scale, (r, k, err, scale)


@pytest.mark.parametrize("name,batch", [("exchange_sh4", "exchange"),
                                        ("exchange_dp2_sh2", "exchange2")])
def test_global_scatter_and_gather(runs, name, batch):
    data = runs["batches"][batch]
    dense, counts, rows = data["dense"], data["counts"], data["rows"]
    n = dense.shape[0]
    el = dense.shape[1] // n
    for r in range(WORLD):
        res = runs["port"][r][name]
        e = res["expert_rank"]
        # dense: [n, E/n, ...] rows of this rank's experts from each rank
        got = res["dense"]["out"].reshape(n, el, *dense.shape[2:])
        for j in range(n):
            np.testing.assert_array_equal(got[j],
                                          dense[j, e * el:(e + 1) * el])
        np.testing.assert_array_equal(res["dense"]["back"], dense[e])
        np.testing.assert_array_equal(res["dense"]["grad"], dense[e])
        assert res["dense_counts"]["global_scatter_bytes"] == \
            dense[e].nbytes * 2      # forward, and the gather's backward
        assert res["dense_counts"]["global_gather_bytes"] == \
            dense[e].nbytes * 2
        # counted: grouped by this rank's expert, then by source rank
        want = []
        for i in range(el):
            for j in range(n):
                start = int(counts[j, :e * el + i].sum())
                want.append(rows[j][start:start + int(counts[j, e * el + i])])
        np.testing.assert_array_equal(res["counted"]["out"],
                                      np.concatenate(want))
        np.testing.assert_array_equal(res["counted"]["back"], rows[e])
        np.testing.assert_array_equal(res["counted"]["grad"], rows[e])


@pytest.mark.parametrize("config", list(ROWS_CONFIGS))
def test_ep_over_axis_the_batch_is_not_split_over(runs, config):
    """Every rank of the expert group holds the same 3 rows: each computes
    its experts on its slots and the outputs are summed over the group,
    with no exchange. Losses (rel 1e-5) and parameters after 3 steps
    against the reference's ``TrainStep`` on the whole batch; the first
    step's gradients (every rank's the same, the expert slices gathered)
    within ``GRAD_TOL`` of each parameter's largest reference gradient."""
    losses = _losses(runs, config)
    want, final = runs["ref"]["rows"]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _assert_params_close(runs["port"][0][config]["full"], final)
    ref_grads = runs["ref"]["rows_grads"]
    for r in range(WORLD):
        res = runs["port"][r][config]
        assert res["expert_axis"] == "data"
        assert res["local"]["moe.w_in"].shape[0] == \
            E // ROWS_CONFIGS[config]["dp"]
        assert res["counts"].get("global_scatter_bytes", 0) == 0
        assert sorted(res["grads"]) == sorted(ref_grads)
        for k, g in ref_grads.items():
            scale = np.abs(g).max()
            assert scale > 0, (r, k)
            err = np.abs(res["grads"][k] - g).max()
            assert err <= GRAD_TOL * scale, (r, k, err, scale)
