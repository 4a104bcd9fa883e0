"""ZeRO-3 and the sep axis inside the pipeline (pp x sharding stage 3, pp x
sep) of the PyTorch port against the reference, at world size 4 on the CPU
(gloo, one spawn running every job, as ``test_torch_pipeline.py``).

The ranks of one sharding group, and those of one sep group, share a pipe
stage: they replay the same row of ``phased_stage_table``, so their
gathers, reduce-scatters and ring rotations meet in the same order. Held
here, on the same full weights and global batches as the reference:

- the tiny GPT (tied embeddings) at pp 2 x sharding 2, stage 3, under
  gpipe, 1F1B, interleaved 1F1B (V = 2), zero bubble, recompute and a
  binding ``ClipGradByGlobalNorm``, and the tiny Llama under 1F1B, against
  the reference's ``TrainStep`` and (GPT) its own ``DistTrainStep`` at
  pp 2 x sharding 2, stage 3 (dp filled to its 8-device mesh): losses
  within ``LOSS_RTOL``, gathered parameters by ``test_torch_pipeline``'s
  rule; the bytes each rank gathers, gathers again in the backward and
  reduce-scatters a step against the arithmetic of its stage;
- each rank's slice of every parameter against the reference's device
  shard at the same (pipe, sharding) coordinate;
- a pp 2 x sharding 2 stage-3 run resumed at dp 2 x mp 2 from the full
  model and optimizer arrays, and the reverse (the reference's
  loss-parity TinyLM, ``tests/test_checkpoint_reshard.py``'s switch and
  tolerances);
- ``PipelineParallel.train_batch`` of a ``PipelineLayer`` at pp 2 x
  sharding 2, stage 3, through ``fleet.distributed_model`` and through
  ``group_sharded_parallel(level="p_g_os")``, against the reference's
  ``PipelineLayer`` under ``TrainStep``;
- pp 2 x sep 2 under 1F1B and interleaved 1F1B, GPT (the plain ring) and
  Llama (the kernels' route on their plain versions), and a masked mean,
  against the reference's ``TrainStep`` and (GPT) its ``DistTrainStep``
  at pp 2 x sep 2, which runs on its mesh (its GPT attention does not
  split the sequence there: the same math); each rank's ring rotations
  and boundary messages counted;
- recompute at sep 2 outside a pipeline (dp 2 x sep 2): the recomputed
  forward runs under the sequence split (it raised a checkpoint mismatch
  before: the backward ran outside the split).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.op import raw
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

from test_torch_pipeline import (CLIP, LOSS_RTOL, _assert_params_close,
                                 _batches, _ref_loss_fn, _ref_model,
                                 _ref_pipe_layer, _ref_train,
                                 _stacked_natural, _trajectory)
from test_torch_zero3 import _tiny_ref
from torch_port_utils import (TINY_LM, fleet_adamw, fleet_jobs, join_ranks,
                              no_mesh, numpy_state, spawn_ranks,
                              tiny_lm_data)

WORLD = 4
STEPS = 3
LAYERS = 4
# tests/test_checkpoint_reshard.py
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-5
SWITCH = 5

Z3 = dict(pp=2, sharding=2, stage=3)
SEP = dict(pp=2, sep=2)
# name -> the pipeline job's model, degrees and schedule
JOBS = {
    "gpt_z3_gpipe": dict(model="gpt", schedule="gpipe", acc=4, **Z3),
    "gpt_z3_1f1b": dict(model="gpt", schedule="1f1b", acc=4, **Z3),
    "gpt_z3_v2": dict(model="gpt", schedule="1f1b", vpp=2, acc=2, **Z3),
    "gpt_z3_zero_bubble": dict(model="gpt", schedule="zero_bubble", acc=4,
                               **Z3),
    "gpt_z3_recompute": dict(model="gpt", schedule="1f1b", acc=4,
                             use_recompute=True, **Z3),
    "gpt_z3_clip": dict(model="gpt", schedule="1f1b", acc=4, clip=CLIP,
                        **Z3),
    "llama_z3_1f1b": dict(model="llama", schedule="1f1b", acc=2, **Z3),
    # the reference's knobs (bench_configs.py::run_gpt_6p7b_ppsharding):
    # bf16 parameters, recomputed blocks
    "gpt_z3_bf16_recompute": dict(model="gpt", schedule="1f1b", acc=4,
                                  use_recompute=True, bf16=True, **Z3),
    "gpt_sep_1f1b": dict(model="gpt", schedule="1f1b", acc=2, **SEP),
    "gpt_sep_v2": dict(model="gpt", schedule="1f1b", vpp=2, acc=2, **SEP),
    "llama_sep_1f1b": dict(model="llama", schedule="1f1b", acc=2, **SEP),
    "llama_sep_v2": dict(model="llama", schedule="1f1b", vpp=2, acc=2,
                         **SEP),
    "gpt_mask_sep_1f1b": dict(model="gpt", schedule="1f1b", acc=2,
                              batch="gpt_mask", **SEP),
}
Z3_JOBS = [n for n, j in JOBS.items() if j.get("stage") == 3
           and not j.get("bf16")]
SEP_JOBS = [n for n, j in JOBS.items() if j.get("sep")]
PP_Z3 = {"pp_degree": 2, "sharding_degree": 2}
HYBRID = {"dp_degree": 2, "mp_degree": 2}


def _ref_dist(kind, state, batch, stage=1, **degrees):
    """The reference's pipelined ``DistTrainStep`` (dp filled to its
    8-device mesh) at ``degrees``."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, **degrees)
        s.sharding_configs["stage"] = stage
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_model(kind, _stacked_natural(state, "gpt.decoder.", LAYERS))
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        m = ref_fleet.distributed_model(m)
        opt = ref_fleet.distributed_optimizer(opt)
        return _trajectory(ref_fleet.DistTrainStep(m, _ref_loss_fn(batch),
                                                   opt), m, batch)


def _unstacked(state, prefix="gpt.decoder."):
    """A stacked state (layers in natural order) under the unfolded
    names."""
    out = {}
    for k, v in state.items():
        rest = k[len(prefix):]
        if k.startswith(prefix) and "__" in rest:
            for i in range(v.shape[0]):
                out[f"{prefix}{i}.{rest.replace('__', '.')}"] = v[i]
        else:
            out[k] = v
    return out


def _ref_pp_shards(state):
    """The reference's placement of the tiny GPT at pp 2 x sharding 2,
    stage 3: ``{name: {(pipe, sharding) coordinate: device shard}}``."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, **PP_Z3)
        s.sharding_configs["stage"] = 3
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_model("gpt", _stacked_natural(state, "gpt.decoder.",
                                               LAYERS))
        ref_fleet.distributed_model(m)
        out = {}
        for n, p in m.named_parameters():
            v = raw(p)
            spec = tuple(v.sharding.spec) + (None,) * v.ndim
            shards = {}
            for sh in v.addressable_shards:
                coord = []
                for axis, n_axis in (("pp", 2), ("sharding", 2)):
                    if axis in spec:
                        d = spec.index(axis)
                        coord.append((sh.index[d].start or 0)
                                     // (v.shape[d] // n_axis))
                    else:
                        coord.append(None)
                shards[tuple(coord)] = np.asarray(sh.data)
            out[n] = shards
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    with no_mesh():
        states = {k: numpy_state(_ref_model(k)) for k in ("gpt", "llama")}
        paddle.seed(1234)
        states["tiny_lm"] = numpy_state(GPTForCausalLM(GPTConfig(**TINY_LM)))
    pipe_state, pipe_ref = _ref_pipe_layer(batches["pipe_lm"])
    states["pipe_lm"] = pipe_state
    batches["tiny_lm"] = tiny_lm_data()
    jobs = [dict(name=n, kind="pipeline", layers=LAYERS, **kw)
            for n, kw in JOBS.items()]
    jobs.append(dict(name="slices", kind="pp_zero3_slices", model="gpt",
                     layers=LAYERS, **Z3))
    for api in ("distributed_model", "group_sharded_parallel"):
        jobs.append(dict(name=f"train_batch_{api}", kind="pipeline_layer",
                         model="pipe_lm", schedule="1f1b", acc=2, api=api,
                         **Z3))
    jobs += [dict(name="tiny_pp_z3", kind="tiny_lm", model="tiny_lm",
                  batch="tiny_lm", phases=[(PP_Z3, 3, 10)]),
             dict(name="resume_pp_z3_to_hybrid", kind="tiny_lm",
                  model="tiny_lm", batch="tiny_lm",
                  phases=[(PP_Z3, 3, SWITCH), (HYBRID, 1, 10 - SWITCH)]),
             dict(name="resume_hybrid_to_pp_z3", kind="tiny_lm",
                  model="tiny_lm", batch="tiny_lm",
                  phases=[(HYBRID, 1, SWITCH), (PP_Z3, 3, 10 - SWITCH)])]
    jobs += [dict(name=f"{m}_sep_recompute", model=m, dp=2, sep=2,
                  config=dict(num_hidden_layers=LAYERS, use_recompute=True))
             for m in ("gpt", "llama")]
    out = tmp_path_factory.mktemp("pp_compose")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, batches)
    try:
        ref = {k: _ref_train(k, states[k], batches[k])
               for k in ("gpt", "llama")}
        ref["gpt_mask"] = _ref_train("gpt", states["gpt"],
                                     batches["gpt_mask"])
        ref["gpt_clip"] = _ref_train("gpt", states["gpt"], batches["gpt"],
                                     CLIP)
        ref["dist_z3"] = _ref_dist("gpt", states["gpt"], batches["gpt"],
                                   stage=3, **PP_Z3)
        ref["dist_sep"] = _ref_dist("gpt", states["gpt"], batches["gpt"],
                                    pp_degree=2, sep_degree=2)
        ref["shards"] = _ref_pp_shards(states["gpt"])
        ref["pipe_lm"] = pipe_ref
        ref["tiny_lm"] = _tiny_ref({})
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, states=states, batches=batches)


def _want_of(name, runs):
    job = JOBS[name]
    if "clip" in job:
        return runs["ref"]["gpt_clip"]
    return runs["ref"][job.get("batch", job["model"])]


# ----------------------------------------------- ZeRO-3 inside the pipeline
@pytest.mark.parametrize("name", Z3_JOBS)
def test_zero3_pipeline_matches_reference_train_step(runs, name):
    """Losses within LOSS_RTOL of the reference's TrainStep, the full
    (gathered) parameters by the pipeline tests' rule, every rank the
    same losses and the same gathered state."""
    want_losses, want = _want_of(name, runs)
    if "clip" in JOBS[name]:
        # the clip binds: the trajectory is not the unclipped one
        assert abs(want_losses[2] - runs["ref"]["gpt"][0][2]) > 1e-4
    res = [runs["port"][r][name] for r in range(WORLD)]
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=LOSS_RTOL)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    assert set(want) <= set(res[0]["full"])
    _assert_params_close(res[0]["full"], want)
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for n, v in res[0]["stacked"].items():
            assert np.array_equal(r["stacked"][n], v), (name, n)


@pytest.mark.parametrize("name", [n for n in Z3_JOBS if n.startswith("gpt")
                                  and "clip" not in n])
def test_zero3_pipeline_matches_reference_dist_train_step(runs, name):
    """Against the reference's own DistTrainStep at pp 2 x sharding 2,
    stage 3: the losses and, name for name, the stacked state (the
    interleaved run's layers stand in another order: its full state is
    held against the reference's under the unfolded names)."""
    got = runs["port"][0][name]
    want_losses, want = runs["ref"]["dist_z3"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert sorted(got["stacked"]) == sorted(want)
    _assert_params_close(got["full"], _unstacked(want))


def _zero3_bytes(job, res):
    """The ZeRO-3 bytes a rank of the tiny GPT moves in STEPS steps, from
    its slices: the other rank's part of each sliced parameter. Every
    forward op reads its chunk's blocks and the embeddings (the layers
    before the stack run on every stage); the last chunk's also the final
    norm and the tied head (the word embedding again). The backward
    reduce-scatters what reaches the loss (the embeddings on the first
    chunk only) and gathers again every weight an op saved (the linear
    weights, the norms' weights and biases, the tied head), every sliced
    block parameter when the block recomputes; under zero bubble a chunk
    with an input runs its backward twice."""
    S, V = job["pp"], job.get("vpp", 1)
    stage, M = res["stage"], res["microbatches"]
    got = {n: b for n, b in res["slice_bytes"].items()}
    blocks = sum(b for n, b in got.items() if ".decoder." in n)
    saved = sum(b for n, b in got.items() if ".decoder." in n and not (
        n.endswith(".bias") and ".ln_" not in n))
    emb = sum(b for n, b in got.items() if ".embeddings." in n)
    head = sum(b for n, b in got.items() if "final_layernorm" in n) + \
        got["gpt.embeddings.word_embeddings.weight"]
    first, last = stage == 0, stage == S - 1
    if job.get("use_recompute"):
        saved = blocks
    back = saved * M + last * head * M
    if job["schedule"] == "zero_bubble":
        back = sum(saved // V * M * (1 + (v * S + stage > 0))
                   for v in range(V)) + last * head * M * 2
    return dict(gather=STEPS * (blocks * M + emb * M * V + last * head * M),
                reduce_scatter=STEPS * (blocks * M + first * emb * M
                                        + last * head * M),
                regather=STEPS * back)


@pytest.mark.parametrize("name", [n for n, j in JOBS.items()
                                  if j.get("stage") == 3
                                  and n.startswith("gpt")])
def test_zero3_bytes_follow_the_schedule(runs, name):
    """What each rank gathered, gathered again and reduce-scattered equals
    the arithmetic of its stage and schedule; the two sharding peers of a
    stage moved the same."""
    job = JOBS[name]
    for r in range(WORLD):
        res = runs["port"][r][name]
        c = res["collective"]
        want = _zero3_bytes(job, res)
        got = dict(gather=c["zero3_gather_bytes"],
                   reduce_scatter=c["zero3_reduce_scatter_bytes"],
                   regather=c["zero3_regather_bytes"])
        assert got == want, (name, r, got, want)


@pytest.mark.parametrize("name", Z3_JOBS)
def test_no_gathered_weight_outlives_its_forward_op(runs, name):
    """When a micro-batch's forward op ends (on a stage that hands on, by
    ending the loss function early), no gathered weight is alive: the
    stash of 1F1B and the interleaved schedule keeps the slices' views
    only, and the backward gathers again."""
    for r in range(WORLD):
        res = runs["port"][r][name]
        seen = res["alive_after_forward"]
        assert len(seen) >= res["counts"]["forward_ops"]
        assert set(seen) == {0}, (name, r, seen)


def test_bf16_recompute_loss_falls(runs):
    """The reference's own criterion for its pp x sharding stage-3 run at
    bf16 with recompute (``bench_configs.py::run_gpt_6p7b_ppsharding``):
    the loss finite and falling, the same on every rank."""
    res = [runs["port"][r]["gpt_z3_bf16_recompute"] for r in range(WORLD)]
    losses = res[0]["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for r in res[1:]:
        assert r["losses"] == losses


def test_stack_casts_like_the_reference():
    """``bfloat16()`` reaches a folded stack's blocks, as the reference's
    does (``SpmdPipeline`` shadowed ``Module._apply``, so any dtype or
    device move of a model with a stack raised ``TypeError``): the cast
    state equals the reference's cast state bit for bit."""
    from torch_port_utils import port_model

    with no_mesh():
        ref = _ref_model("gpt", None, fold_layers=True)
        state = _unstacked(numpy_state(ref))
        ref.bfloat16()
        want = numpy_state(ref)
    port = port_model("gpt", state, num_hidden_layers=LAYERS,
                      fold_layers=True)
    port.bfloat16()
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert str(v.dtype) == "torch.bfloat16", k
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)


def test_each_slice_is_the_reference_device_shard(runs):
    """Each rank's state (its stage's stacked entries and the embeddings,
    each cut to its slice) against the reference's device shard at the
    same (pipe, sharding) coordinate; the stacked entries are cut on the
    reference's dim (the block's dim + 1)."""
    shards = runs["ref"]["shards"]
    stacked = [n for n in shards if "__" in n]
    assert stacked and all(k[0] is not None for n in stacked
                           for k in shards[n])
    for r in range(WORLD):
        res = runs["port"][r]["slices"]
        pipe, sh = res["coord"]
        assert sorted(res["state"]) == sorted(shards)
        for n, per in shards.items():
            key = next(k for k in per if k[0] in (None, pipe)
                       and k[1] in (None, sh))
            np.testing.assert_array_equal(res["state"][n], per[key],
                                          err_msg=n)


def test_binding_clip_counts_every_slice_once(runs):
    """The global norm sums the slices' squares over sharding, then the
    stage-local ones over pipe, the replicated ones once: with a clip that
    binds the trajectory is the reference's clipped one (and not the
    unclipped one)."""
    got = runs["port"][0]["gpt_z3_clip"]["losses"]
    np.testing.assert_allclose(got, runs["ref"]["gpt_clip"][0],
                               rtol=LOSS_RTOL)
    assert abs(got[2] - runs["ref"]["gpt"][0][2]) > 1e-4


@pytest.mark.parametrize("name", ["resume_pp_z3_to_hybrid",
                                  "resume_hybrid_to_pp_z3"])
def test_checkpoint_resumes_across_degrees_with_pp(runs, name):
    """``tests/test_checkpoint_reshard.py``'s switch with pp kept: 5 steps
    under one layout, the full model and optimizer arrays gathered (the
    optimizer's by the parameters' places in the unpipelined model), 5
    more under the other; the 10 losses follow the uninterrupted degree-1
    reference, and the uninterrupted pp 2 x sharding 2 stage-3 run closer
    than that."""
    got = runs["port"][0][name]["losses"]
    np.testing.assert_allclose(got, runs["ref"]["tiny_lm"],
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)
    whole = runs["port"][0]["tiny_pp_z3"]["losses"]
    np.testing.assert_allclose(whole, runs["ref"]["tiny_lm"],
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)
    np.testing.assert_allclose(got, whole, rtol=1e-5)
    for r in range(1, WORLD):
        assert runs["port"][r][name]["losses"] == got


def test_rank_holds_its_stage_slices(runs):
    """A pp 2 x sharding 2 stage-3 rank holds at most half of its stage's
    blocks and of the embeddings, plus what no dim of which 2 divides."""
    got = runs["port"][0]["tiny_pp_z3"]
    assert got["sliced"] > 0
    total = sum(v.nbytes for v in runs["states"]["tiny_lm"].values())
    blocks = sum(v.nbytes for n, v in runs["states"]["tiny_lm"].items()
                 if ".decoder." in n)
    assert got["resident_bytes"] <= (total - blocks / 2) / 2 \
        + got["whole_bytes"]


@pytest.mark.parametrize("api", ["distributed_model",
                                 "group_sharded_parallel"])
def test_train_batch_at_zero3(runs, api):
    """``PipelineParallel.train_batch`` of a ``PipelineLayer`` (a shared
    embedding as the tied head) at pp 2 x sharding 2, stage 3, against the
    reference's ``PipelineLayer`` under ``TrainStep``; ``eval_batch``
    gives the loss on every rank."""
    want_losses, want = runs["ref"]["pipe_lm"]
    res = [runs["port"][r][f"train_batch_{api}"] for r in range(WORLD)]
    for r in res:
        assert r["wrapper"] == "PipelineParallel"
        assert r["sliced"] > 0
        np.testing.assert_allclose(r["losses"], want_losses, rtol=LOSS_RTOL)
        assert r["losses"] == res[0]["losses"]
        assert r["eval_loss"] == res[0]["eval_loss"]
    _assert_params_close(res[0]["full"], want)


# --------------------------------------------------- sep inside the pipeline
def _boundary_messages(S, V, stage):
    return sum((c % S == stage) + ((c + 1) % S == stage)
               for c in range(S * V - 1))


@pytest.mark.parametrize("name", SEP_JOBS)
def test_sep_pipeline_matches_reference(runs, name):
    """pp 2 x sep 2: losses within LOSS_RTOL of the reference's TrainStep
    (the masked mean's count summed over the token group), the gathered
    parameters by the pipeline tests' rule, every rank alike; GPT's also
    against the reference's DistTrainStep at pp 2 x sep 2."""
    job = JOBS[name]
    want_losses, want = _want_of(name, runs)
    res = [runs["port"][r][name] for r in range(WORLD)]
    rel = np.max(np.abs(np.asarray(res[0]["losses"]) - want_losses)
                 / np.abs(want_losses))
    print(f"pp 2 x sep 2 {name}: loss rel to the reference {rel:.2e}")
    np.testing.assert_allclose(res[0]["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params_close(res[0]["full"], want)
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
    if job["model"] == "gpt" and "batch" not in job:
        dist_losses, dist = runs["ref"]["dist_sep"]
        np.testing.assert_allclose(res[0]["losses"], dist_losses,
                                   rtol=LOSS_RTOL)
        _assert_params_close(res[0]["full"], _unstacked(dist))


@pytest.mark.parametrize("name", SEP_JOBS)
def test_sep_pipeline_rotates_the_ring_in_every_op(runs, name):
    """Each rank's point to point: per layer and micro-batch one ring
    rotation forward and one back (the ring ran in every forward op and
    its backward), beside the pipeline's boundary messages; the two sep
    peers of a stage alike."""
    job = JOBS[name]
    S, V = job["pp"], job.get("vpp", 1)
    for r in range(WORLD):
        res = runs["port"][r][name]
        M, layers = res["microbatches"], LAYERS // S
        want = STEPS * M * (2 * layers + 2 * _boundary_messages(
            S, V, res["stage"]))
        assert res["p2p"] == want, (name, r, res["p2p"], want)


@pytest.mark.parametrize("model", ["gpt", "llama"])
def test_recompute_under_the_sequence_split(runs, model):
    """dp 2 x sep 2 without a pipeline, blocks recomputed: the recomputed
    forward runs the ring at the block's positions, as the first run did;
    against the reference's TrainStep."""
    want_losses, want = runs["ref"][model]
    got = runs["port"][0][f"{model}_sep_recompute"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params_close(got["full"], want)
