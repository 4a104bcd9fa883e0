"""Pipeline parallelism of the PyTorch port against the reference, on the
CPU.

The host-side parts (``phased_stage_table``, ``schedule_info``,
``resolve_pp_schedule``, ``_choose_microbatches``) against the
reference's functions over a sweep. Then training at world size 4 over
gloo (one process per rank, one spawn for every job, as
``test_torch_fleet.py``): the tiny GPT and Llama at 4 layers, dropout-free,
3 AdamW steps (clip 1.0) through ``fleet.init`` -> ``distributed_model``
-> ``distributed_optimizer`` -> ``DistTrainStep`` at pp 2 / 4 with dp, mp
+ SP, ZeRO-1, the interleaved and zero-bubble schedules, an uneven loss
mask, an engaged clip and recomputing blocks, each held against the
reference's ``TrainStep`` on the same full weights and global batch (and
``gpt_pp2_dp2`` against the reference's own pipelined ``DistTrainStep``
on its 8-device mesh), and a ``PipelineLayer`` of ``LayerDesc`` /
``SharedLayerDesc`` through ``PipelineParallel.train_batch`` against the
reference's ``PipelineLayer`` under ``TrainStep``."""
import warnings

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_parallel as rpp
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu.text.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    pipeline_parallel as tpp)

from torch_port_utils import (FLEET_LR, PIPE_LM, fleet_adamw, fleet_jobs,
                              join_ranks, no_mesh, numpy_state,
                              pipe_layer_lm, spawn_ranks, tiny_gpt_kwargs,
                              tiny_llama_kwargs)

WORLD = 4
STEPS = 3
LAYERS = 4
# test_torch_fleet.py's tolerances: f32 through the blocks, the head and
# the CE on both sides, summed in another order
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * FLEET_LR * STEPS
MAX_NOISY_FRACTION = 0.01
# below the tiny GPT's gradient norm, so ClipGradByGlobalNorm scales
CLIP = 0.05

# name -> model, batch and the port job's degrees / schedule
JOBS = {
    "gpt_pp2_dp2": dict(model="gpt", pp=2, dp=2, schedule="gpipe", acc=4),
    "gpt_pp2_mp2_sp": dict(model="gpt", pp=2, mp=2, sp=True,
                           schedule="1f1b", acc=4),
    # a clip norm the gradients exceed: the global norm must take every
    # stage's squares once
    "gpt_pp4": dict(model="gpt", pp=4, schedule="1f1b", acc=8, clip=CLIP),
    "gpt_pp2_v2": dict(model="gpt", pp=2, dp=2, schedule="1f1b", vpp=2,
                       acc=4),
    "llama_pp2_zero_bubble": dict(model="llama", pp=2, dp=2,
                                  schedule="zero_bubble", acc=2),
    "gpt_pp2_sharding2": dict(model="gpt", pp=2, sharding=2,
                              schedule="1f1b", acc=4),
    # blocks that recompute themselves in the backward, under both
    # backward orders (zero-bubble differentiates each chunk twice)
    "gpt_pp2_recompute": dict(model="gpt", pp=2, dp=2, schedule="1f1b",
                              acc=2, use_recompute=True),
    "gpt_pp2_zero_bubble_recompute": dict(model="gpt", pp=2, dp=2,
                                          schedule="zero_bubble", acc=2,
                                          use_recompute=True),
    # the rows keep 1..8 tokens unevenly: each micro-batch and each data
    # rank holds another share of the count
    "gpt_mask_pp2_dp2": dict(model="gpt", pp=2, dp=2, schedule="1f1b",
                             acc=2, batch="gpt_mask"),
}


def _batches():
    rng = np.random.default_rng(23)
    ids = rng.integers(0, 64, (8, 16))
    labels = rng.integers(0, 64, (8, 16))
    mask = np.zeros((8, 16), np.float32)
    for row, keep in enumerate((2, 16, 7, 0, 1, 9, 0, 12)):
        mask[row, rng.permutation(16)[:keep]] = 1.0
    llama_labels = labels.copy()
    llama_labels[0, :13] = -100
    llama_labels[5, :3] = -100
    return {"gpt": dict(ids=ids, labels=labels),
            "gpt_mask": dict(ids=ids, labels=labels, mask=mask),
            "llama": dict(ids=ids, labels=llama_labels),
            "pipe_lm": dict(ids=rng.integers(0, PIPE_LM["vocab"], (8, 6)),
                            labels=rng.integers(0, PIPE_LM["vocab"],
                                                (8, 6)))}


def _ref_model(kind, state=None, **kw):
    paddle.seed(7)
    if kind == "gpt":
        m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(
            vocab_size=64, num_hidden_layers=LAYERS, **kw)))
    else:
        m = LlamaForCausalLM(LlamaConfig(**tiny_llama_kwargs(
            vocab_size=64, num_hidden_layers=LAYERS, **kw)))
    if state is not None:
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    m.eval()
    return m


def _ref_loss_fn(batch):
    if "mask" in batch:
        return lambda m, i, lab, k: m(i, labels=lab, loss_mask=k)
    return lambda m, i, lab: m(i, labels=lab)


def _trajectory(step, model, batch):
    args = [Tensor(jnp.asarray(batch[k])) for k in ("ids", "labels", "mask")
            if k in batch]
    losses = [float(np.asarray(raw(step(*args)))) for _ in range(STEPS)]
    return losses, {n: np.asarray(raw(p)) for n, p in
                    model.named_parameters()}


def _ref_train(kind, state, batch, clip_norm=1.0):
    with no_mesh():
        m = _ref_model(kind, state)
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm,
                          clip_norm=clip_norm)
        return _trajectory(RefTrainStep(m, _ref_loss_fn(batch), opt), m,
                           batch)


def _stacked_natural(state, prefix, layers):
    """An unfolded GPT state in the reference's stacked layout at V = 1."""
    out, leaves = {}, {}
    for k, v in state.items():
        if k.startswith(prefix):
            layer, leaf = k[len(prefix):].split(".", 1)
            leaves.setdefault(leaf, {})[int(layer)] = v
        else:
            out[k] = v
    for leaf, per in leaves.items():
        out[prefix + leaf.replace(".", "__")] = np.stack(
            [per[i] for i in range(layers)])
    return out


def _ref_dist_pp(state, batch, pp):
    """The reference's own pipelined DistTrainStep (gpipe, M = S) on its
    8-device mesh, dp filled."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, pp_degree=pp)
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_model("gpt", _stacked_natural(state, "gpt.decoder.", LAYERS))
        assert isinstance(m.gpt.decoder, rpp.SpmdPipeline)
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        m = ref_fleet.distributed_model(m)
        opt = ref_fleet.distributed_optimizer(opt)
        return _trajectory(ref_fleet.DistTrainStep(m, _ref_loss_fn(batch),
                                                   opt), m, batch)


def _ref_pipe_layer(batch):
    """The reference's PipelineLayer (no mesh: its stack is the fold) under
    TrainStep; returns its state before training and the trajectory."""
    with no_mesh():
        paddle.seed(11)
        descs, loss_fn = pipe_layer_lm(paddle)
        pl = rpp.PipelineLayer(descs, num_stages=2, loss_fn=loss_fn)
        state = numpy_state(pl)
        opt = fleet_adamw(pl.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        step = RefTrainStep(pl, lambda m, x, y: loss_fn(m(x), y), opt)
        return state, _trajectory(step, pl, batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    with no_mesh():
        states = {k: numpy_state(_ref_model(k)) for k in ("gpt", "llama")}
    pipe_state, pipe_ref = _ref_pipe_layer(batches["pipe_lm"])
    states["pipe_lm"] = pipe_state
    jobs = [dict(name=n, kind="pipeline", layers=LAYERS, **kw)
            for n, kw in JOBS.items()]
    jobs.append(dict(name="pipeline_layer", kind="pipeline_layer",
                     model="pipe_lm", pp=2, dp=2, schedule="1f1b", acc=2))
    out = tmp_path_factory.mktemp("pipeline")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, batches)
    try:
        ref = {k: _ref_train(k, states[k], batches[k])
               for k in ("gpt", "llama")}
        ref["gpt_mask"] = _ref_train("gpt", states["gpt"],
                                     batches["gpt_mask"])
        ref["gpt_clip"] = _ref_train("gpt", states["gpt"], batches["gpt"],
                                     CLIP)
        ref["gpt_dist_pp2"] = _ref_dist_pp(states["gpt"], batches["gpt"], 2)
        ref["pipe_lm"] = pipe_ref
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


# ------------------------------------------------------------ host parts --
SCHEDULE_SWEEP = [(S, V, M, sched) for S in range(1, 5) for V in (1, 2)
                  for M in range(1, 9) for sched in tpp.PP_SCHEDULES]


@pytest.mark.parametrize("S", range(1, 5))
def test_phased_stage_table_matches_reference(S):
    for _, V, M, sched in (c for c in SCHEDULE_SWEEP if c[0] == S):
        assert tpp.phased_stage_table(S, V, M, sched) == \
            rpp.phased_stage_table(S, V, M, sched), (S, V, M, sched)


class _Stack:
    """The attributes the reference's ``schedule_info`` reads."""

    def __init__(self, S, V, M):
        self.num_stages, self.num_virtual_stages = S, V
        self.num_microbatches, self._schedule = M, None


@pytest.mark.parametrize("S", range(1, 5))
def test_schedule_info_matches_reference(S, monkeypatch):
    # the reference reads a pp mesh axis; with none it reports the fold
    monkeypatch.setattr(rpp, "_uses_scan_fallback", lambda n: n <= 1)
    for _, V, M, sched in (c for c in SCHEDULE_SWEEP if c[0] == S):
        want = rpp.SpmdPipeline.schedule_info(_Stack(S, V, M), 8, sched)
        m = rpp._choose_microbatches(8, M, warn=False)
        assert tpp.schedule_info(S, V, m, sched) == want, (S, V, M, sched)


@pytest.mark.parametrize("env", [
    "", "gpipe", "1f1b", "zero_bubble", "schedule=1f1b,virtual=2",
    "zero_bubble,vpp=3", "virtual_pp_degree=2", "ZERO_BUBBLE",
    "schedule=bogus", "interleaved", "depth=2"])
def test_resolve_pp_schedule_matches_reference(env, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PP_SCHEDULE", env)
    s, ref_s = fleet.DistributedStrategy(), ref_fleet.DistributedStrategy()
    for strategy in (s, ref_s):
        strategy.pipeline_configs["schedule"] = "1f1b"
        strategy.pipeline_configs["virtual_pp_degree"] = 2
    try:
        want = rpp.resolve_pp_schedule(ref_s)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpp.resolve_pp_schedule(s)
        assert str(got.value) == str(e)
        return
    got = tpp.resolve_pp_schedule(s)
    assert (got.schedule, got.virtual_pp_degree) == (
        want.schedule, want.virtual_pp_degree)


def test_strategy_schedule_errors_match_reference():
    s, ref_s = fleet.DistributedStrategy(), ref_fleet.DistributedStrategy()
    for strategy in (s, ref_s):
        strategy.pipeline_configs["schedule"] = "wavefront"
    with pytest.raises(ValueError) as want:
        rpp._strategy_pp_config(ref_s)
    with pytest.raises(ValueError) as got:
        tpp._strategy_pp_config(s)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch, requested", [(8, 4), (8, 3), (6, 4),
                                              (7, 2), (2, 8), (12, 5)])
def test_choose_microbatches_matches_reference(batch, requested):
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = rpp._choose_microbatches(batch, requested)
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = tpp._choose_microbatches(batch, requested)
    assert got == want
    assert [str(w.message) for w in got_w] == [str(w.message)
                                               for w in want_w]


# ------------------------------------------------------------- training --
@pytest.mark.parametrize("name", list(JOBS))
def test_trajectory_matches_reference_train_step(runs, name):
    job = JOBS[name]
    batch = job.get("batch", job["model"])
    want_losses, want = runs["ref"]["gpt_clip" if "clip" in job else batch]
    if "clip" in job:
        # the clip scales: the trajectory is not the unclipped one
        assert abs(want_losses[2] - runs["ref"]["gpt"][0][2]) > 1e-4
    res = [runs["port"][r][name] for r in range(WORLD)]
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=LOSS_RTOL)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    # the full state holds the parameters and Llama's RoPE tables
    assert set(want) <= set(res[0]["full"])
    assert all("rope_" in n for n in set(res[0]["full"]) - set(want))
    _assert_params_close(res[0]["full"], want)
    for r in res[1:]:
        # every rank returns the same global loss and the same full state
        assert r["losses"] == res[0]["losses"]
        for n, v in res[0]["stacked"].items():
            assert np.array_equal(r["stacked"][n], v), (name, n)


@pytest.mark.parametrize("name", list(JOBS))
def test_replicated_parameters_bit_equal_across_pp_ranks(runs, name):
    """The embeddings, the final norm (and Llama's head) are on every pipe
    rank; after 3 steps they are bit-equal on the ranks of one mp
    coordinate, and no decoder block is among them."""
    res = [runs["port"][r][name] for r in range(WORLD)]
    stages = {r["stage"] for r in res}
    assert stages == set(range(JOBS[name]["pp"]))
    names = set(res[0]["replicated"])
    assert names and not any(".decoder." in n or ".layers." in n
                             for n in names)
    for r in res[1:]:
        assert set(r["replicated"]) == names
        if r["mp_rank"] != res[0]["mp_rank"]:
            continue
        for n in names:
            assert np.array_equal(r["replicated"][n],
                                  res[0]["replicated"][n]), (name, n)


def test_pipelined_dist_train_step_matches_the_references(runs):
    """gpt_pp2_dp2 against the reference's own pipelined DistTrainStep at
    pp 2: the same losses and, name for name, the same stacked state (the
    reference's SpmdPipeline layout)."""
    got = runs["port"][0]["gpt_pp2_dp2"]
    want_losses, want = runs["ref"]["gpt_dist_pp2"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(want_losses, runs["ref"]["gpt"][0],
                               rtol=LOSS_RTOL)
    assert sorted(got["stacked"]) == sorted(want)
    _assert_params_close(got["stacked"], want)


def test_uneven_mask_gives_the_global_masked_mean(runs):
    """The masked mean of the whole batch (not the mean of the micro-batch
    or data-rank means): the rows keep 2, 16, 7, 0, 1, 9, 0 and 12
    tokens."""
    got = runs["port"][0]["gpt_mask_pp2_dp2"]
    b = runs["batches"]["gpt_mask"]["mask"]
    per_mb = b.reshape(4, 2, 16).sum((1, 2))
    assert len(set(per_mb.tolist())) > 1
    want_losses, _ = runs["ref"]["gpt_mask"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(JOBS))
def test_schedule_ops_and_boundary_traffic(runs, name):
    """Every stage ran M x V forward and backward ops a step; the
    replicated gradients crossed the pipe group once a step; CPU tensors
    were not staged through the host."""
    job = JOBS[name]
    rows = 8 // (WORLD // (job["pp"] * job.get("mp", 1)))
    m = tpp._choose_microbatches(rows, job["acc"], warn=False)
    for r in range(WORLD):
        res = runs["port"][r][name]
        ops = m * job.get("vpp", 1) * STEPS
        assert res["counts"]["forward_ops"] == ops
        assert res["counts"]["backward_ops"] == ops
        assert res["counts"]["replicated_grad_bytes"] > 0
        assert res["staged"] == 0 and res["p2p"] > 0


def test_pipeline_layer_train_batch_matches_reference(runs):
    want_losses, want = runs["ref"]["pipe_lm"]
    res = [runs["port"][r]["pipeline_layer"] for r in range(WORLD)]
    for r in res:
        assert r["wrapper"] == "PipelineParallel"
        assert r["kinds"] == ["Embedding", "SpmdPipeline", "_ForwardWrapper"]
        np.testing.assert_allclose(r["losses"], want_losses, rtol=LOSS_RTOL)
        assert r["losses"] == res[0]["losses"]
    full = res[0]["full"]
    for n, w in want.items():
        assert n in full, n
    _assert_params_close(full, want)
    # eval_batch: the loss on every rank, the logits on the last stage
    for r in res:
        assert r["eval_loss"] == res[0]["eval_loss"]
        assert (r["logits"] is None) == (r["stage"] == 0)
    last = next(r for r in res if r["stage"] == 1)
    assert last["logits"].shape == (8, 6, PIPE_LM["vocab"])


def test_pp_degree_trains_and_other_knobs_still_raise():
    """pp_degree > 1 passes the strategy check, and so do sep_degree > 1
    and ZeRO-3, alone and with pp (the ring and the slices inside a
    pipeline, ``tests/test_torch_pp_compose.py``); Lamb passes with pp
    since the meta-optimizers were ported, and ``auto_plan`` since the
    planner was."""
    from paddle_tpu_torch.distributed.fleet.strategy import check_ported

    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = 2
    check_ported(s)
    s = fleet.DistributedStrategy()
    s.hybrid_configs["sep_degree"] = 2
    check_ported(s)
    for knob in ("sep_pp", "stage3"):
        s = fleet.DistributedStrategy()
        if knob == "sep_pp":
            s.hybrid_configs.update(sep_degree=2, pp_degree=2)
        else:  # ZeRO-3 alone is ported (tests/test_torch_zero3.py)
            s.sharding_configs["stage"] = 3
            check_ported(s)
            s.hybrid_configs["pp_degree"] = 2
        check_ported(s)
    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = 2
    s.lamb = True  # ported: tests/test_torch_lamb_fleet.py
    check_ported(s)
    # auto_plan passes since the planner was ported (ROADMAP §A.7 item 4;
    # tests/test_torch_planner.py), and the pinned pp survives its plan
    from paddle_tpu_torch.distributed.auto_parallel import planner

    for knob, item in (("auto_plan", "§A.7"),):
        s = fleet.DistributedStrategy()
        s.hybrid_configs["pp_degree"] = 2
        setattr(s, knob, True)
        check_ported(s)
        assert planner.apply_auto_plan(s, 4) is not None, item
        assert s.hybrid_configs["pp_degree"] == 2 and s.pipeline


def test_pipelined_stack_outside_its_schedule_raises():
    """A stack whose pipe group is set up runs only under its schedule; the
    same stack with no group is the fold (the reference's fallback)."""
    import torch

    from paddle_tpu_torch.distributed.fleet.topology import (
        CommunicateTopology, HybridCommunicateGroup,
        set_hybrid_communicate_group)

    blocks = [torch.nn.Linear(4, 4) for _ in range(4)]
    fold = tpp.SpmdPipeline(blocks, num_stages=2)
    assert not fold.pipelined and len(fold.blocks) == 4
    x = torch.ones(2, 4)
    want = x
    for b in blocks:
        want = b(want)
    assert torch.equal(fold(x), want)
    topo = CommunicateTopology(("data", "pipe", "sharding", "sep", "model"),
                               (1, 2, 1, 1, 1))
    set_hybrid_communicate_group(HybridCommunicateGroup(topo, global_rank=1))
    try:
        pipe = tpp.SpmdPipeline(blocks, num_stages=2)
        assert pipe.pipelined and pipe.stage == 1 and len(pipe.blocks) == 2
        assert pipe.blocks[0] is blocks[2]
        with pytest.raises(RuntimeError, match="run_schedule"):
            pipe(x)
        with pytest.raises(NotImplementedError, match="extra"):
            pipe(x, x)
    finally:
        set_hybrid_communicate_group(None)
    with pytest.raises(ValueError, match="structurally identical"):
        tpp.SpmdPipeline([torch.nn.Linear(4, 4), torch.nn.Linear(4, 2)])
    with pytest.raises(ValueError, match="not divisible"):
        tpp.SpmdPipeline(blocks[:3], num_stages=2, num_virtual_stages=1)
