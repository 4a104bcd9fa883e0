"""Hybrid-parallel training of the PyTorch port against the reference, at
world size 4 on the CPU (gloo, one process per rank, ``file://``
rendezvous, the spawn joined under its own time limit).

The tiny GPT (2 layers, hidden 32, 4 heads, vocab 64) and Llama (G = 2)
of ``torch_port_utils`` take 3 AdamW steps (clip 1.0) through
``fleet.init`` -> ``distributed_model`` -> ``distributed_optimizer`` ->
``DistTrainStep`` on the same full weights and global batch as the
reference's ``DistTrainStep`` at the same mp / sharding (its dp filled up
to its 8 devices) and its ``TrainStep``. One spawn runs every port job in
turn while this process runs the reference."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.io import DistributedBatchSampler as RefSampler
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu.text.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.jit import TrainStep

from torch_port_utils import (FLEET_LR, batched_inputs, batched_loss,
                              batched_net, fleet_adamw, fleet_jobs,
                              join_ranks, no_mesh, numpy_state, port_model,
                              spawn_ranks, tiny_gpt_kwargs,
                              tiny_llama_kwargs)

WORLD = 4
STEPS = 3
# f32 through two blocks, the head and the CE on both sides (reduction
# orders differ by ulps), as test_torch_train.py
LOSS_RTOL = 1e-5
# Adam moves an element by about lr * sign(g), so an element whose
# gradient is float noise on both sides can drift by up to 2 * lr a step;
# all must stay within that and all but 1 % within PARAM_ATOL
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * FLEET_LR * STEPS
MAX_NOISY_FRACTION = 0.01
# bf16 parameters (multi_precision, f32 masters) against the f32
# reference: the loss sees bf16 weights and activations (unit roundoff
# 2^-8, a few roundings on the way), a parameter its bf16 rounding; the
# gradients differ by bf16 noise, which Adam's normalised step turns into
# moves of up to lr where they are small, so all but 1 % of the elements
# must agree within one step's move (lr) past the rounding
BF16_LOSS_RTOL = 4 * 2.0 ** -8
BF16_PARAM_RTOL = 2.0 ** -8
BF16_PARAM_ATOL = FLEET_LR

# port jobs: name -> degrees; the reference runs each at the same mp /
# sharding / sequence_parallel with dp filling its 8 devices
CONFIGS = {
    "dp2_mp2": dict(dp=2, mp=2),
    "mp2_sp": dict(mp=2, sp=True),
    "mp2_sh2": dict(mp=2, sharding=2),
    "dp2_sh2_mpre": dict(dp=2, sharding=2, multi_precision=True),
}
MODELS = ("gpt", "llama")
# ZeRO (sharding > 1) against sharding 1 over the same data ranks: the
# same gradients, an elementwise update, so bit-equal
ZERO_PAIRS = [("gpt_dp2_sh2", "gpt_dp4"), ("gpt_dp2_sh2_s2", "gpt_dp4"),
              ("gpt_mp2_sh2", "gpt_dp2_mp2"),
              ("llama_mp2_sh2", "llama_dp2_mp2"),
              ("gpt_dp2_sh2_mpre", "gpt_dp4_mpre"),
              ("llama_dp2_sh2_mpre", "llama_dp4_mpre")]
EXTRA_JOBS = [
    dict(name="gpt_dp4", model="gpt"),
    dict(name="gpt_dp2_sh2", model="gpt", dp=2, sharding=2),
    dict(name="gpt_dp2_sh2_s2", model="gpt", dp=2, sharding=2, stage=2),
    dict(name="gpt_dp4_mpre", model="gpt", multi_precision=True),
    dict(name="llama_dp4_mpre", model="llama", multi_precision=True),
    # masks that keep 2, 16, 7 and 0 tokens of the four rows: each data
    # rank's share of the global count differs
    dict(name="gpt_mask_dp4", model="gpt", batch="gpt_mask"),
    dict(name="gpt_mask_mp2_sp", model="gpt", mp=2, sp=True,
         batch="gpt_mask"),
    # a batch of 3 rows does not divide over 4 data ranks: whole on each
    dict(name="gpt_b3_dp4", model="gpt", batch="gpt_b3"),
    dict(name="data_parallel", kind="data_parallel", model="gpt"),
    dict(name="group_sharded_os", kind="group_sharded", model="gpt",
         level="os"),
    dict(name="group_sharded_os_g", kind="group_sharded", model="gpt",
         level="os_g"),
    dict(name="api", kind="api", model="gpt", mp=2),
]
# batch-coupled reductions (ROADMAP.md §C.26): each case at dp 4 and at
# dp 2 x sharding 2 against the reference's DistTrainStep at dp 2
BATCHED_CASES = ("ignore", "weight", "sum", "bn")
BATCHED_CONFIGS = {"dp4": {}, "dp2_sh2": dict(dp=2, sharding=2)}
BATCHED_JOBS = [dict(name=f"batched_{c}_{k}", kind="batched", case=c,
                     model="batched_bn" if c == "bn" else "batched",
                     batch=f"batched_{c}", **kw)
                for c in BATCHED_CASES for k, kw in BATCHED_CONFIGS.items()]
# losses of the §C.26 cases: f32 through two small layers, the reduction
# orders differ by ulps
BATCHED_RTOL = 1e-6


def _batches():
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 64, (4, 16))
    labels = rng.integers(0, 64, (4, 16))
    mask = np.zeros((4, 16), np.float32)
    for row, keep in enumerate((2, 16, 7, 0)):
        mask[row, rng.permutation(16)[:keep]] = 1.0
    llama_labels = labels.copy()
    llama_labels[0, :13] = -100          # ignored labels, unevenly by rank
    llama_labels[3, :2] = -100
    return {"gpt": dict(ids=ids, labels=labels),
            "gpt_mask": dict(ids=ids, labels=labels, mask=mask),
            "gpt_b3": dict(ids=ids[:3], labels=labels[:3]),
            "llama": dict(ids=ids, labels=llama_labels)}


def _ref_model(kind, state, sequence_parallel=False):
    paddle.seed(7)
    if kind == "gpt":
        m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(
            vocab_size=64, sequence_parallel=sequence_parallel)))
    else:
        m = LlamaForCausalLM(LlamaConfig(**tiny_llama_kwargs(
            vocab_size=64, sequence_parallel=sequence_parallel)))
    if state is not None:
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    m.eval()
    return m


def _ref_loss_fn(batch):
    if "mask" in batch:
        return lambda m, i, lab, k: m(i, labels=lab, loss_mask=k)
    return lambda m, i, lab: m(i, labels=lab)


def _ref_args(batch):
    return [Tensor(jnp.asarray(batch[k])) for k in ("ids", "labels", "mask")
            if k in batch]


def _trajectory(step, model, batch):
    losses = [float(np.asarray(raw(step(*_ref_args(batch)))))
              for _ in range(STEPS)]
    return losses, {n: np.asarray(raw(p)) for n, p in
                    model.named_parameters()}


def _ref_batched(case, state, batch):
    """The reference's DistTrainStep at dp 2 on the §C.26 case: one
    program over the global batch."""
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=2)
        ref_fleet.init(is_collective=True, strategy=s)
        m = batched_net(paddle, case == "bn")
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        m = ref_fleet.distributed_model(m)
        opt = ref_fleet.distributed_optimizer(opt)
        step = ref_fleet.DistTrainStep(
            m, batched_loss(paddle.nn.functional, case), opt)
        args = [Tensor(jnp.asarray(batch[k])) for k in ("x", "y", "w")
                if k in batch]
        losses = [float(np.asarray(raw(step(*args)))) for _ in range(STEPS)]
        return losses, {n: np.asarray(raw(p)) for n, p in
                        m.named_parameters()}, {
            n: np.asarray(raw(b)) for n, b in m.named_buffers()}


def _ref_train(kind, state, batch):
    with no_mesh():
        m = _ref_model(kind, state)
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        return _trajectory(RefTrainStep(m, _ref_loss_fn(batch), opt), m,
                           batch)


def _ref_dist(kind, state, batch, mp=1, sharding=1, sp=False):
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, mp_degree=mp,
                                sharding_degree=sharding)
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_model(kind, state, sp)
        opt = fleet_adamw(m.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        m = ref_fleet.distributed_model(m)
        opt = ref_fleet.distributed_optimizer(opt)
        return _trajectory(
            ref_fleet.DistTrainStep(m, _ref_loss_fn(batch), opt), m, batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's jobs (one spawn of WORLD ranks) and the reference's
    trajectories, computed while the ranks run."""
    batches = _batches()
    batches.update({f"batched_{c}": b
                    for c, b in batched_inputs().items()})
    with no_mesh():
        states = {k: numpy_state(_ref_model(k, None)) for k in MODELS}
        for key, bn in (("batched", False), ("batched_bn", True)):
            paddle.seed(26)
            states[key] = numpy_state(batched_net(paddle, bn))
    jobs = [dict(name=f"{m}_{c}", model=m, **kw)
            for m in MODELS for c, kw in CONFIGS.items()] + EXTRA_JOBS \
        + BATCHED_JOBS
    out = tmp_path_factory.mktemp("fleet")
    for job in jobs:
        job["save_dir"] = str(out)
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, batches)
    try:
        ref = {}
        for m in MODELS:
            ref[m] = _ref_train(m, states[m], batches[m])
            for c, kw in CONFIGS.items():
                ref[f"{m}_{c}"] = _ref_dist(
                    m, states[m], batches[m], kw.get("mp", 1),
                    kw.get("sharding", 1), kw.get("sp", False))
        ref["gpt_mask"] = _ref_train("gpt", states["gpt"], batches["gpt_mask"])
        for c in BATCHED_CASES:
            ref[f"batched_{c}"] = _ref_batched(
                c, states["batched_bn" if c == "bn" else "batched"],
                batches[f"batched_{c}"])
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, states=states, batches=batches,
                out=out)


def _assert_params_close(got, want, rtol=0.0, atol=PARAM_ATOL):
    noisy = total = 0
    for n, w in want.items():
        d = np.abs(got[n] - w) - rtol * np.abs(w)
        assert d.max() <= NOISE_BOUND, (n, d.max())
        noisy += int((d > atol).sum())
        total += d.size
    assert noisy <= MAX_NOISY_FRACTION * total, (noisy, total)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("model", MODELS)
def test_trajectory_matches_reference(runs, model, config):
    name = f"{model}_{config}"
    got = runs["port"][0][name]
    dist_losses, dist_final = runs["ref"][name]
    train_losses, _ = runs["ref"][model]
    # the reference's DistTrainStep is its TrainStep's math
    np.testing.assert_allclose(dist_losses, train_losses, rtol=LOSS_RTOL)
    bf16 = CONFIGS[config].get("multi_precision", False)
    rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    np.testing.assert_allclose(got["losses"], dist_losses, rtol=rtol)
    np.testing.assert_allclose(got["losses"], train_losses, rtol=rtol)
    assert got["losses"][-1] < got["losses"][0]
    assert sorted(got["local"]) == sorted(dist_final)
    if bf16:
        _assert_params_close(got["full"], dist_final, BF16_PARAM_RTOL,
                             BF16_PARAM_ATOL)
    else:
        _assert_params_close(got["full"], dist_final)
    # every rank returns the same global loss
    for r in range(WORLD):
        assert runs["port"][r][name]["losses"] == got["losses"]


@pytest.mark.parametrize("config", [c for c in CONFIGS
                                    if CONFIGS[c].get("mp", 1) > 1])
@pytest.mark.parametrize("model", MODELS)
def test_parameters_agree_across_ranks(runs, model, config):
    """After 3 steps every replicated parameter (norms, row-linear biases,
    position embeddings) is bit-equal on all ranks, and each mp shard on
    the ranks of the same mp coordinate; the shards gather to the same
    full state everywhere."""
    name = f"{model}_{config}"
    res = [runs["port"][r][name] for r in range(WORLD)]
    dist = set(res[0]["distributed"])
    assert dist, name
    for n in res[0]["local"]:
        for r in range(1, WORLD):
            if n not in dist or res[r]["mp_rank"] == res[0]["mp_rank"]:
                assert np.array_equal(res[r]["local"][n],
                                      res[0]["local"][n]), (n, r)
    for r in range(1, WORLD):
        for n, v in res[0]["full"].items():
            assert np.array_equal(res[r]["full"][n], v), (n, r)


@pytest.mark.parametrize("model", MODELS)
def test_sequence_parallel_parameters(runs, model):
    """Under mp2 + SP the norms (and GPT's row-linear biases) are the
    sequence-parallel parameters, their gradients summed over mp."""
    got = runs["port"][0][f"{model}_mp2_sp"]["sequence_parallel"]
    want = [n for n in runs["states"][model] if "norm" in n or "ln_" in n]
    if model == "gpt":
        want += [n for n in runs["states"][model]
                 if n.endswith(("out_proj.bias", "fc_out.bias"))]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("zero, plain", ZERO_PAIRS)
def test_zero_bit_equal_to_sharding_one(runs, zero, plain):
    for r in range(WORLD):
        a, b = runs["port"][r][zero], runs["port"][r][plain]
        assert a["losses"] == b["losses"]
        for n, v in b["full"].items():
            assert np.array_equal(a["full"][n], v), (zero, n, r)
        # each rank keeps the state (and masters) of its parameters only
        assert a["states"] == a["owned"] < b["states"], (zero, r)
        if "mpre" in zero:
            assert a["masters"] == a["owned"] < b["masters"]
    # every parameter has one owner in each of the WORLD / 2 sharding
    # groups
    assert sum(runs["port"][r][zero]["owned"] for r in range(WORLD)) == \
        len(runs["port"][0][plain]["local"]) * (WORLD // 2)


@pytest.mark.parametrize("name", ["gpt_mask_dp4", "gpt_mask_mp2_sp"])
def test_uneven_loss_mask_is_the_global_masked_mean(runs, name):
    """The rows keep 2, 16, 7 and 0 tokens: averaging the data ranks'
    own masked means would give another loss; the port's is the global
    ``sum(loss * mask) / sum(mask)``, as the reference's."""
    got = runs["port"][0][name]
    want_losses, want = runs["ref"]["gpt_mask"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params_close(got["full"], want)


@pytest.mark.parametrize("config", list(BATCHED_CONFIGS))
@pytest.mark.parametrize("case", BATCHED_CASES)
def test_batch_coupled_reductions_are_global(runs, case, config):
    """ROADMAP.md §C.26: an ``ignore_index`` mean whose valid counts differ
    by rank, a ``[C]`` class weight given as a batch argument (it stays
    whole), a ``reduction="sum"`` loss and batch norm in training reduce
    over the global batch, as the reference's one program does: the
    losses, the parameters after 3 steps and the running buffers (equal
    on every rank) match its DistTrainStep at dp 2."""
    name = f"batched_{case}_{config}"
    want_losses, want, want_buffers = runs["ref"][f"batched_{case}"]
    got = runs["port"][0][name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=BATCHED_RTOL)
    assert sorted(got["full"]) == sorted(want)
    _assert_params_close(got["full"], want)
    assert sorted(got["buffers"]) == sorted(want_buffers)
    for n, v in want_buffers.items():
        np.testing.assert_allclose(got["buffers"][n], v, rtol=BATCHED_RTOL,
                                   atol=1e-7)
    for r in range(1, WORLD):
        other = runs["port"][r][name]
        assert other["losses"] == got["losses"]
        for n, v in got["buffers"].items():
            assert np.array_equal(other["buffers"][n], v), (n, r)


def test_batch_that_does_not_divide_stays_whole(runs):
    state, batch = runs["states"]["gpt"], runs["batches"]["gpt_b3"]
    m = port_model("gpt", state)
    opt = fleet_adamw(m.parameters(), topt, topt.ClipGradByGlobalNorm)
    step = TrainStep(m, lambda mm, i, lab: mm(i, labels=lab), opt)
    args = [torch.from_numpy(batch[k]) for k in ("ids", "labels")]
    want = [float(step(*args)) for _ in range(STEPS)]
    got = runs["port"][0]["gpt_b3_dp4"]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    _assert_params_close(got["full"], {n: p.detach().numpy()
                                       for n, p in m.named_parameters()})


def test_data_parallel(runs):
    losses, want = runs["ref"]["gpt"]
    res = [runs["port"][r]["data_parallel"] for r in range(WORLD)]
    # each rank's loss is its own quarter's; their mean is the global one
    np.testing.assert_allclose(np.mean([r["losses"] for r in res], 0),
                               losses, rtol=LOSS_RTOL)
    for r in res:
        _assert_params_close(r["full"], want)
        for n, v in res[0]["full"].items():
            assert np.array_equal(r["full"][n], v)


@pytest.mark.parametrize("level", ["os", "os_g"])
def test_group_sharded_parallel(runs, level):
    losses, want = runs["ref"]["gpt"]
    res = [runs["port"][r][f"group_sharded_{level}"] for r in range(WORLD)]
    np.testing.assert_allclose(np.mean([r["losses"] for r in res], 0),
                               losses, rtol=LOSS_RTOL)
    assert sum(r["states"] for r in res) == len(want)
    for r in res:
        _assert_params_close(r["full"], want)


def test_save_group_sharded_model(runs):
    """The last group-sharded job's model (every rank equal) from rank 0,
    and each rank's own optimizer state (its owned parameters')."""
    from paddle_tpu_torch.framework.io_state import load

    saved = load(str(runs["out"] / "gs.pdparams"), return_numpy=True)
    want = runs["port"][0]["group_sharded_os_g"]["full"]
    assert sorted(saved) == sorted(want)
    for n, v in want.items():
        np.testing.assert_array_equal(saved[n], v)
    owned = [load(str(runs["out"] / f"gs.rank{r}.pdopt"), return_numpy=True)
             for r in range(WORLD)]
    moments = [k for o in owned for k in o if k.endswith(".moment1")]
    assert len(moments) == len(set(moments)) == len(want)


def test_distributed_batch_sampler_defaults_to_the_data_axes(runs):
    for r in range(WORLD):
        got = {k: v for k, v in runs["port"][r]["api"].items()
               if isinstance(k, tuple)}
        for (shuffle, drop_last), (n, rank, batches, length) in got.items():
            # fleet.init(mp=2) at world 4: dp 2, the mp pairs share data
            assert (n, rank) == (2, r // 2)
            ref = RefSampler(list(range(11)), batch_size=2, num_replicas=n,
                             rank=rank, shuffle=shuffle, drop_last=drop_last)
            assert batches == list(ref) and length == len(ref)


@pytest.mark.parametrize("knob, item", [
    ("pp", "§A.7"), ("sep", "§A.7"), ("stage3", "§A.7"),
    ("grad_comm_bf16", "§A.7"), ("grad_comm_int8", "§A.7"),
    ("mp_comm", "§A.7"), ("gradient_merge", "§A.7"), ("lars", "§A.3"),
    ("lamb", "§A.3"), ("auto_plan", "§A.7")])
def test_unported_knobs_raise(knob, item, monkeypatch):
    """Each raised in fleet.init, before any process group is set up, and
    in distributed_optimizer, until it was ported. pp_degree > 1 passes
    the strategy check since pipeline parallelism was ported
    (tests/test_torch_pipeline.py), sep_degree > 1 since the sep axis was
    (tests/test_torch_sep.py), and with pp_degree > 1 since the ring runs
    inside a pipeline (tests/test_torch_pp_compose.py). ZeRO-3 (with pp as
    well), the bf16 / int8 gradient wire, mp_comm and gradient_merge pass
    since they were ported, and so do the Lars / Lamb meta-optimizers
    (tests/test_torch_lamb_fleet.py). ``auto_plan`` passes since the
    planner was ported (tests/test_torch_planner.py): ``fleet.init``
    fills the unpinned degrees as the reference's does."""
    from paddle_tpu_torch.distributed.fleet.strategy import check_ported

    s = fleet.DistributedStrategy()
    if knob == "auto_plan":
        from paddle_tpu.distributed.fleet import DistributedStrategy as RefS
        from paddle_tpu.distributed.auto_parallel import planner as ref_pl

        from torch_port_utils import same_planner_constants

        same_planner_constants(monkeypatch)
        s = fleet.DistributedStrategy.auto()
        s.hybrid_configs["mp_degree"] = 2          # a manual pin wins
        check_ported(s)
        # fleet.init at a world of 8 without a process group: the hybrid
        # group holds rank lists only
        monkeypatch.setattr(fleet, "init_parallel_env", lambda: None)
        monkeypatch.setattr(fleet, "get_world_size", lambda: 8)
        fleet.init(is_collective=True, strategy=s)
        try:
            want = RefS.auto()
            want.hybrid_configs["mp_degree"] = 2
            ref_pl.apply_auto_plan(want, 8)
            for k in ("dp_degree", "mp_degree", "pp_degree",
                      "sharding_degree"):
                assert s.hybrid_configs[k] == want.hybrid_configs[k], k
            assert dict(s.pipeline_configs) == dict(want.pipeline_configs)
            hcg = fleet.get_hybrid_communicate_group()
            assert hcg.get_model_parallel_world_size() == 2
            assert hcg.nranks == 8
        finally:
            fleet.topology.set_hybrid_communicate_group(None)
        return
    if knob == "pp":
        s.hybrid_configs["pp_degree"] = 2
        check_ported(s)
        return
    if knob in ("stage3", "grad_comm_bf16", "grad_comm_int8", "mp_comm",
                "gradient_merge", "lars", "lamb"):
        # ported: ZeRO-3 (tests/test_torch_zero3.py), the gradient wire
        # (test_torch_grad_wire.py), the mp wire (test_torch_mp_comm.py),
        # gradient merge (test_torch_gradient_merge.py) and the Lars /
        # Lamb meta-optimizers (test_torch_lamb_fleet.py)
        if knob == "stage3":
            s.sharding_configs["stage"] = 3
            check_ported(s)
            s.hybrid_configs["pp_degree"] = 2
        elif knob.startswith("grad_comm"):
            s.grad_comm = True
            s.grad_comm_configs["wire_dtype"] = knob.rsplit("_", 1)[1]
        else:
            setattr(s, knob, True)
        check_ported(s)
        return
    if knob == "sep":
        s.hybrid_configs[f"{knob}_degree"] = 2
        check_ported(s)
        s.hybrid_configs["pp_degree"] = 2
        check_ported(s)
        return
    setattr(s, knob, True)
    with pytest.raises(NotImplementedError, match=item):
        fleet.init(is_collective=True, strategy=s)
    with pytest.raises(NotImplementedError, match=item):
        fleet.distributed_optimizer(None, strategy=s)
    assert fleet.get_hybrid_communicate_group() is None


def test_zero3_entry_points_raise(runs):
    """Both ZeRO-3 entry points raised until ZeRO-3 was ported; now they
    return (``api_job`` calls them at sharding 4: each rank keeps a
    quarter of the ``[8, 8]`` weight), and a level that does not exist
    still raises."""
    for r in range(WORLD):
        got = runs["port"][r]["api"]["zero3_entry_points"]
        assert got == dict(group_sharded_stage=3, level_p_g_os=3,
                           weight_shape=(2, 8)), (r, got)
    with pytest.raises(ValueError, match="level"):
        group_sharded_parallel(None, None, level="p")


@pytest.mark.parametrize("target_mb", [0.0001, 0.001, 1.0])
def test_grad_comm_buckets_match_reference(target_mb):
    """The bucket layouts of the reference's ``build_buckets`` /
    ``make_layouts`` (by byte size, order kept), and pack / unpack with a
    leading dim kept, on the shapes of the tiny GPT's parameters."""
    from paddle_tpu.distributed import grad_comm as ref_gc
    from paddle_tpu_torch.distributed import grad_comm as gc

    shapes = [(64, 32), (128, 32), (32,), (32, 96), (96,), (32, 32), (32,),
              (32, 128), (128,), (128, 32), (32,)]
    target = int(target_mb * 2 ** 20)
    sizes = [4 * int(np.prod(s)) for s in shapes]
    assert gc.build_buckets(sizes, target) == ref_gc.build_buckets(sizes,
                                                                   target)
    # lead_dims=1: a pipeline's stacked leaves, one leading (layer) dim
    stacked = [(2,) + s for s in shapes]
    for lead, shapes in ((0, shapes), (1, stacked)):
        got = gc.make_layouts(shapes, [4] * len(shapes), target,
                              lead_dims=lead)
        want = ref_gc.make_layouts(shapes, [4] * len(shapes), target,
                                   lead_dims=lead)
        assert [vars(g) for g in got] == [vars(w) for w in want]
        rng = np.random.default_rng(3)
        leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for lay, ref_lay in zip(got, want):
            flat = gc.pack_bucket([torch.from_numpy(v) for v in leaves], lay,
                                  lead_dims=lead)
            ref_flat = ref_gc.pack_bucket([jnp.asarray(v) for v in leaves],
                                          ref_lay, lead_dims=lead)
            np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
            for i, v in gc.unpack_bucket(flat, lay, lead_dims=lead):
                np.testing.assert_array_equal(v.numpy(), leaves[i])


@pytest.mark.parametrize("env", ["", "off", "on,bucket_mb=8", "f32",
                                 "bf16", "wire=int8,ef=1,zero=0",
                                 "overlap=0,batch_shard=off"])
def test_grad_comm_resolve_config_matches_reference(monkeypatch, env):
    from paddle_tpu.distributed import grad_comm as ref_gc
    from paddle_tpu.distributed.fleet import DistributedStrategy as RefS
    from paddle_tpu_torch.distributed import grad_comm as gc

    monkeypatch.setenv("PADDLE_TPU_GRAD_COMM", env)
    s, ref_s = fleet.DistributedStrategy(), RefS()
    for strategy in (s, ref_s):
        strategy.fuse_grad_size_in_MB = 16
    got, want = gc.resolve_config(s), ref_gc.resolve_config(ref_s)
    for k in ("enable", "bucket_mb", "wire_dtype", "error_feedback",
              "zero_update", "pipeline_batch_shard", "overlap"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.quantized == want.quantized
    monkeypatch.setenv("PADDLE_TPU_GRAD_COMM", "wire=fp8")
    with pytest.raises(ValueError):
        gc.resolve_config(s)


def test_grad_comm_allreduce_mean_one_rank():
    """A group of one rank: the buckets' average is the identity, bit for
    bit (what phase 38 relies on over NCCL), in 3 buckets here."""
    from paddle_tpu_torch.distributed import grad_comm as gc

    class One:
        nranks = 1

    calls = []
    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((300,), (20, 30), (700,))]
    want = [t.clone() for t in ts]
    import paddle_tpu_torch.distributed.collective as C

    real = C.all_reduce
    try:
        C.all_reduce = lambda t, group=None: calls.append(t.numel())
        n = gc.allreduce_mean(ts + [None], One(), bucket_mb=2400 / 2 ** 20)
    finally:
        C.all_reduce = real
    assert n == 3 and calls == [300, 600, 700]
    for t, w in zip(ts, want):
        assert torch.equal(t, w)


def test_wrappers_and_sequence_parallel_hooks(runs):
    """``TensorParallel`` keeps the model's names and outputs;
    ``GroupShardedStage2`` gives a stage-2 optimizer; the hooks sum a
    sequence-parallel bias's gradient over mp: the output's 3 x 4
    positions are split 3 x 2 a rank, and the hooked gradient counts all
    12 on every rank."""
    for r in range(WORLD):
        got = runs["port"][r]["api"]
        assert got["tensor_parallel"] == (True, True)
        assert got["group_sharded_stage"] == 2
        np.testing.assert_array_equal(got["sp_bias_grad"], np.full(8, 12.0))
