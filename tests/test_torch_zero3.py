"""ZeRO-3 of the PyTorch port (``sharding_configs["stage"] = 3``,
``GroupShardedStage3``, ``group_sharded_parallel(level="p_g_os")``)
against the reference, at world size 4 on the CPU (gloo, one spawn).

The reference places each parameter on its sharding axis
(``shard_model_parameters(fsdp=True)``); the port keeps each rank's slice
of it. Held here:

- each rank's slice of every parameter of the tiny GPT is the reference's
  device shard at the same sharding coordinate;
- the reference's loss-parity TinyLM (``tests/test_loss_parity.py``) at
  sharding 4, dp 2 x sharding 2 and mp 2 + SP x sharding 2, all at stage
  3, against the reference's DistTrainStep at the same degrees and at
  degree 1, under that test's ``_assert_parity``;
- the tiny GPT (tied embeddings) and Llama at sharding 4 against the
  reference's TrainStep, and with recompute and with the fold;
- the eager loop through both entry points;
- resuming a stage-3 run under mp 2 x pp 2 and the reverse from the full
  model and optimizer arrays (``tests/test_checkpoint_reshard.py``'s
  dp 2 x mp 2 x pp 2 at world size 4; a pipelined stage-3 run resumes in
  ``tests/test_torch_pp_compose.py``);
- the parameter bytes a rank holds (``tests/test_memory_analysis.py``).
"""
import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

from test_torch_fleet import (LOSS_RTOL, _assert_params_close, _batches,
                              _ref_model, _ref_train)
from torch_port_utils import (TINY_LM, fleet_jobs, join_ranks, no_mesh,
                              numpy_state, spawn_ranks, tiny_lm_data)

WORLD = 4
# tests/test_loss_parity.py::_assert_parity and
# tests/test_checkpoint_reshard.py
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-5
SWITCH = 5

TINY_CONFIGS = {
    "sh4": ({"sharding_degree": 4}, False),
    "dp2_sh2": ({"dp_degree": 2, "sharding_degree": 2}, False),
    "mp2_sp_sh2": ({"mp_degree": 2, "sharding_degree": 2}, True),
}
HYBRID = {"mp_degree": 2, "pp_degree": 2}
ZERO = {"sharding_degree": 4}
MODEL_JOBS = [
    dict(name="gpt_slices", kind="zero3_slices", model="gpt", dp=1,
         sharding=4, stage=3),
    dict(name="gpt_sh4", model="gpt", dp=1, sharding=4, stage=3),
    dict(name="llama_sh4", model="llama", dp=1, sharding=4, stage=3),
    dict(name="gpt_sh4_recompute", model="gpt", dp=1, sharding=4, stage=3,
         config=dict(use_recompute=True)),
    dict(name="gpt_sh4_fold", model="gpt", dp=1, sharding=4, stage=3,
         config=dict(fold_layers=True)),
    dict(name="gpt_sh4_eager_gsp", kind="zero3_eager", model="gpt",
         api="group_sharded_parallel"),
    dict(name="gpt_sh4_eager_stage3", kind="zero3_eager", model="gpt",
         api="GroupShardedStage3"),
]


def _tiny_ref(degrees, stage=1, sequence_parallel=False):
    """The reference's TinyLM trajectory (its ``_run``) at ``degrees``."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(degrees)
        s.sharding_configs.update(stage=stage)
        ref_fleet.init(is_collective=True, strategy=s)
        paddle.seed(1234)
        model = GPTForCausalLM(GPTConfig(sequence_parallel=sequence_parallel,
                                         **TINY_LM))
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
        ref_fleet.distributed_model(model)
        opt = ref_fleet.distributed_optimizer(opt)
        step = ref_fleet.DistTrainStep(
            model, lambda m, ids, lbl: m(ids, labels=lbl), opt)
        return [float(step(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(ids))))
                for ids in tiny_lm_data()]


def _ref_shards(state):
    """The reference's placement of the tiny GPT at sharding 4, stage 3:
    ``{name: {sharding coordinate: device shard}}``."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(sharding_degree=4)
        s.sharding_configs["stage"] = 3
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_model("gpt", state)
        ref_fleet.distributed_model(m)
        out = {}
        for n, p in m.named_parameters():
            v = raw(p)
            spec = tuple(v.sharding.spec)
            dim = spec.index("sharding") if "sharding" in spec else None
            shards = {}
            for sh in v.addressable_shards:
                idx = (sh.index[dim].start or 0) // (v.shape[dim] // 4) \
                    if dim is not None else 0
                shards[idx] = np.asarray(sh.data)
            out[n] = (dim, shards)
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    with no_mesh():
        states = {k: numpy_state(_ref_model(k, None)) for k in ("gpt",
                                                                "llama")}
        paddle.seed(1234)
        states["tiny_lm"] = numpy_state(GPTForCausalLM(GPTConfig(**TINY_LM)))
    batches["tiny_lm"] = tiny_lm_data()
    out = tmp_path_factory.mktemp("zero3")
    tiny = [dict(name=f"tiny_{c}", kind="tiny_lm", model="tiny_lm",
                 batch="tiny_lm", sp=sp, phases=[(deg, 3, 10)])
            for c, (deg, sp) in TINY_CONFIGS.items()]
    tiny += [dict(name="resume_hybrid_to_zero3", kind="tiny_lm",
                  model="tiny_lm", batch="tiny_lm",
                  phases=[(HYBRID, 1, SWITCH), (ZERO, 3, 10 - SWITCH)]),
             dict(name="resume_zero3_to_hybrid", kind="tiny_lm",
                  model="tiny_lm", batch="tiny_lm",
                  phases=[(ZERO, 3, SWITCH), (HYBRID, 1, 10 - SWITCH)])]
    jobs = tiny + [dict(j, save_dir=str(out)) for j in MODEL_JOBS]
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, batches)
    try:
        ref = {"baseline": _tiny_ref({})}
        for c, (deg, sp) in TINY_CONFIGS.items():
            ref[c] = _tiny_ref(deg, 3, sp)
        for m in ("gpt", "llama"):
            ref[m] = _ref_train(m, states[m], batches[m])
        ref["shards"] = _ref_shards(states["gpt"])
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, states=states, out=out)


def test_each_slice_is_the_reference_device_shard(runs):
    """``tests/test_distributed.py::test_zero3_param_sharding``: every
    parameter the reference shards over the sharding axis is a slice on
    the same dim here, equal to the reference's device shard."""
    shards = runs["ref"]["shards"]
    sliced = [n for n, (dim, _) in shards.items() if dim is not None]
    assert "gpt.embeddings.word_embeddings.weight" in sliced
    assert len(sliced) < len(shards)  # some stay whole (no dim divides)
    for r in range(WORLD):
        local = runs["port"][r]["gpt_slices"]
        assert sorted(local) == sorted(shards)
        for n, (dim, per) in shards.items():
            want = per[r] if dim is not None else per[0]
            np.testing.assert_array_equal(local[n], want, err_msg=n)


@pytest.mark.parametrize("config", list(TINY_CONFIGS))
def test_tiny_lm_parity(runs, config):
    """``tests/test_loss_parity.py``'s TinyLM at stage 3: against the
    reference's DistTrainStep at the same degrees and at degree 1."""
    got = runs["port"][0][f"tiny_{config}"]["losses"]
    for want in (runs["ref"][config], runs["ref"]["baseline"]):
        np.testing.assert_allclose(got, want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
    assert got[-1] < got[0]
    for r in range(1, WORLD):
        assert runs["port"][r][f"tiny_{config}"]["losses"] == got


@pytest.mark.parametrize("model", ["gpt", "llama"])
def test_models_match_reference_train_step(runs, model):
    """The tiny GPT (tied embedding: the LM head reads the embedding's
    gathered weight) and Llama at sharding 4, stage 3, against the
    reference's TrainStep: losses, and the full parameters after 3 steps."""
    want_losses, want = runs["ref"][model]
    got = runs["port"][0][f"{model}_sh4"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params_close(got["full"], want)
    # autograd kept no gathered weight: the backward gathered them again
    assert got["counts"]["zero3_regather"] > 0
    # each gather of the forward has its reduce-scatter in the backward
    assert got["counts"]["zero3_reduce_scatter_bytes"] == \
        got["counts"]["zero3_gather_bytes"] > 0
    for r in range(1, WORLD):
        other = runs["port"][r][f"{model}_sh4"]
        assert other["losses"] == got["losses"]
        for n, v in got["full"].items():
            assert np.array_equal(other["full"][n], v), (n, r)


@pytest.mark.parametrize("variant", ["recompute", "fold"])
def test_recompute_and_fold_at_stage3(runs, variant):
    """The forward run again by recompute gathers again; the fold's blocks
    are sliced as the list's. Both give the stage-3 run's losses."""
    base = runs["port"][0]["gpt_sh4"]
    got = runs["port"][0][f"gpt_sh4_{variant}"]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-6)
    if variant == "recompute":
        for n, v in base["full"].items():
            np.testing.assert_array_equal(got["full"][n], v, err_msg=n)


@pytest.mark.parametrize("api", ["gsp", "stage3"])
def test_eager_loop(runs, api):
    """An eager loop at sharding 4 (each rank's quarter of the batch,
    ``fused_allreduce_gradients`` between backward and step) through
    ``group_sharded_parallel(level="p_g_os")`` and ``GroupShardedStage3``:
    the ranks' mean loss is the reference's, the full parameters match,
    each rank holds slices, and the wrapper's ``state_dict`` and
    ``save_group_sharded_model`` give full arrays."""
    from paddle_tpu_torch.framework.io_state import load

    name = f"gpt_sh4_eager_{api if api == 'stage3' else 'gsp'}"
    losses, want = runs["ref"]["gpt"]
    res = [runs["port"][r][name] for r in range(WORLD)]
    np.testing.assert_allclose(np.mean([r["losses"] for r in res], 0),
                               losses, rtol=LOSS_RTOL)
    for r in res:
        _assert_params_close(r["full"], want)
    emb = [s for n, s in res[0]["local_shapes"].items()
           if n.endswith("word_embeddings.weight")]
    assert emb == [(64, 8)], emb
    saved = load(str(runs["out"] / f"{name}.pdparams"), return_numpy=True)
    assert sorted(saved) == sorted(want)
    for n, v in res[0]["full"].items():
        np.testing.assert_array_equal(saved[n], v)
        if api == "stage3":
            np.testing.assert_array_equal(res[0]["wrapper_state"][n], v)


@pytest.mark.parametrize("name", ["resume_hybrid_to_zero3",
                                  "resume_zero3_to_hybrid"])
def test_checkpoint_resumes_across_degrees(runs, name):
    """``tests/test_checkpoint_reshard.py``: 5 steps under one layout, the
    full model and optimizer arrays gathered, 5 more under the other from
    them; the 10 losses follow the uninterrupted degree-1 reference."""
    got = runs["port"][0][name]["losses"]
    np.testing.assert_allclose(got, runs["ref"]["baseline"],
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)
    # and the uninterrupted stage-3 run, closer than the tolerance
    np.testing.assert_allclose(got, runs["port"][0]["tiny_sh4"]["losses"],
                               rtol=1e-5)


def test_rank_holds_its_slices(runs):
    """``tests/test_memory_analysis.py``: the parameter bytes a rank holds
    at stage 3 are at most a 1/n share of the model plus the parameters
    no dim of which n divides (kept whole)."""
    got = runs["port"][0]["tiny_sh4"]
    total = sum(v.nbytes for v in runs["states"]["tiny_lm"].values())
    assert got["sliced"] > 0
    assert got["resident_bytes"] <= total / WORLD + got["whole_bytes"]
    assert got["resident_bytes"] < total / 2


def test_stage3_with_pipeline_raises():
    """ZeRO-3 with pp passes the strategy check (the slices inside a
    pipeline, ``tests/test_torch_pp_compose.py``); what still raises in a
    pipeline at stage 3 is a MoE layer whose experts split over the
    sharding axis, naming §A.7 item 1 (the reference has no pipelined MoE
    model to hold it against)."""
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.strategy import check_ported
    from paddle_tpu_torch.distributed.fleet.topology import (
        CommunicateTopology, HybridCommunicateGroup,
        get_hybrid_communicate_group, set_hybrid_communicate_group)

    s = fleet.DistributedStrategy()
    s.sharding_configs["stage"] = 3
    s.hybrid_configs["pp_degree"] = 2
    check_ported(s)
    topo = CommunicateTopology(("data", "pipe", "sharding", "sep", "model"),
                               (1, 2, 2, 1, 1))
    prev = get_hybrid_communicate_group()
    # rank lists only: the layer raises before it reaches a collective
    set_hybrid_communicate_group(HybridCommunicateGroup(topo, global_rank=0))
    try:
        with pytest.raises(NotImplementedError, match="§A.7 item 1"):
            incubate.MoELayer(d_model=8, d_hidden=16, num_experts=4, top_k=2,
                              device="cpu")
    finally:
        set_hybrid_communicate_group(prev)
