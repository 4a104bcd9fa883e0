"""Fleet's Lars / Lamb meta-optimizers and the split-aware norms of the
PyTorch port against the reference, at world size 4 on the CPU (gloo, one
spawn of 4 ranks running every job in turn while this process computes
the references).

- The swap itself (``tests/test_distributed.py``'s case): ``Momentum`` ->
  ``Lars``, ``Adam`` / ``AdamW`` -> ``Lamb``, from the strategy's configs,
  in both packages.
- The tiny GPT (2 layers, hidden 32) for 3 ``DistTrainStep`` s under Lamb
  at dp 2 x mp 2 and at mp 2 x sharding 2 stage 3, under Lars at dp 2 x
  sharding 2 stage 3, and under AdamW with ``ClipGradByNorm`` at mp 2:
  each against the reference's ``DistTrainStep`` at the same mp /
  sharding / stage (its dp fills its 8 devices), whose GSPMD program
  takes every norm over the whole parameter. A control job runs Lamb at
  dp 2 x mp 2 with the split sum switched off (each rank's trust ratio of
  its shard alone): it must miss the reference by more than the
  tolerance, so the gate sees a shard-only norm.
- Lamb on the EP MoE net (``moe_net``, 8 experts) with its experts split
  over sharding 2 at dp 2 x sharding 2, against the reference's
  ``DistTrainStep`` at sharding 2.
- The gradient wire: the reference's explicit f32 wire at dp 2 x sharding
  2 runs its update on shard-shaped arrays, so its Lamb trust ratios are
  per shard and miss its own ``TrainStep``; the port's (ZeRO-1 updates
  whole parameters on their owner) matches the ``TrainStep``. ROADMAP.md
  §C records the difference.
- ``autograd.saved_tensors_hooks`` opened inside a ZeRO-3 forward (the
  loss function of a stage-3 ``DistTrainStep`` at sharding 4): the losses
  equal the run without hooks bit for bit, the user's hooks pack saved
  tensors and the backward unpacks them, no gathered weight is alive when a forward ends,
  and the backward re-gathers (the weights were saved as slices).

Tolerances: losses within 1e-5 relative (f32 through the tiny GPT, as
``test_torch_fleet.py``). Parameters within 1e-6 absolute plus 1e-6
relative, all but 1 % of the elements: the exceptions are elements whose
gradient is float noise on both sides (the key third of ``qkv_proj.bias``:
softmax does not see a key bias), which Adam's and Lamb's normalised step
moves by up to about ``lr`` a step either way, so every element must stay
within ``2 * lr * steps`` (as ``test_torch_fleet.py``). At 3 steps the
port is off in 0.2 % of the elements, the shard-only control in over half.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
import paddle_tpu_torch as tp
from paddle_tpu_torch.distributed import fleet

from torch_port_utils import (FLEET_LR, LAMB_CONFIGS, fleet_jobs,
                              fleet_optimizer, join_ranks, meta_strategy,
                              moe_net, no_mesh, numpy_state, spawn_ranks,
                              tiny_gpt_kwargs, wire_ids, wire_loss, wire_net,
                              wire_strategy)

WORLD = 4
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-6
NOISE_BOUND = 2 * FLEET_LR * STEPS
MAX_NOISY_FRACTION = 0.01

# name -> the job (degrees as the port runs them; the reference runs the
# same mp / sharding / stage with dp filled)
GPT_JOBS = {
    "lamb_dp2_mp2": dict(dp=2, mp=2, meta="lamb"),
    "lamb_mp2_sh2_s3": dict(mp=2, sharding=2, stage=3, meta="lamb"),
    "lars_dp2_sh2_s3": dict(dp=2, sharding=2, stage=3, meta="lars"),
    "clipnorm_mp2": dict(mp=2, clip="norm"),
}
CONTROL = dict(dp=2, mp=2, meta="lamb", local_norms=True)
MOE_JOB = dict(dp=2, sharding=2, meta="lamb")
WIRE_JOB = dict(dp=2, sharding=2, wire="f32", meta="lamb")
HOOK_JOBS = {"hooks": dict(dp=1, sharding=4, stage=3, hooks=True,
                           watch=True),
             "plain": dict(dp=1, sharding=4, stage=3)}


def _gpt_batch():
    rng = np.random.default_rng(21)
    return dict(ids=rng.integers(0, 64, (4, 16)),
                labels=rng.integers(0, 64, (4, 16)))


def _moe_batch():
    rng = np.random.default_rng(42)
    return dict(x=[rng.integers(0, 64, (8, 16)) for _ in range(STEPS)])


def _ref_gpt(state):
    paddle.seed(7)
    m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(vocab_size=64)))
    if state is not None:
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    m.eval()
    return m


def _ref_moe(state=None):
    paddle.seed(55)
    m = moe_net(paddle)
    if state is not None:
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    m.eval()
    return m


def _ref_strategy(job):
    s = ref_fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=-1, mp_degree=job.get("mp", 1),
                            sharding_degree=job.get("sharding", 1))
    s.sharding_configs["stage"] = job.get("stage", 1)
    return meta_strategy(s, job)


def _ref_dist(job, model, loss_fn, batches):
    """The reference's losses and final parameters under ``job``'s
    strategy through its ``DistTrainStep``."""
    with no_mesh():
        s = _ref_strategy(job)
        ref_fleet.init(is_collective=True, strategy=s)
        m = model()
        opt = fleet_optimizer(job, m.parameters(), paddle.optimizer,
                              paddle.nn)
        m = ref_fleet.distributed_model(m)
        opt = ref_fleet.distributed_optimizer(opt, s)
        step = ref_fleet.DistTrainStep(m, loss_fn, opt)
        losses = [float(np.asarray(raw(step(*[Tensor(jnp.asarray(a))
                                                for a in args]))))
                  for args in batches]
        return dict(losses=losses, inner=type(opt._inner_opt).__name__,
                    params={n: np.asarray(raw(p))
                            for n, p in m.named_parameters()})


def _ref_wire_train(state, ids):
    """The reference's ``TrainStep`` with the Lamb the swap makes: the
    whole-parameter norms."""
    with no_mesh():
        m = wire_net(paddle)
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
        opt = paddle.optimizer.Lamb(learning_rate=1e-2, epsilon=1e-8,
                                    parameters=m.parameters(),
                                    **LAMB_CONFIGS)
        step = RefTrainStep(m, wire_loss(paddle.nn.functional), opt)
        x = Tensor(jnp.asarray(ids))
        losses = [float(np.asarray(raw(step(x, x)))) for _ in range(STEPS)]
        return dict(losses=losses, params={
            n: np.asarray(raw(p)) for n, p in m.named_parameters()})


def _ref_wire_dist(state, ids):
    with no_mesh():
        s = meta_strategy(wire_strategy(WIRE_JOB, ref_fleet), WIRE_JOB)
        ref_fleet.init(is_collective=True, strategy=s)
        m = wire_net(paddle)
        m.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
        opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=m.parameters(),
                                     weight_decay=0.1)
        m = ref_fleet.distributed_model(m)
        step = ref_fleet.DistTrainStep(m, wire_loss(paddle.nn.functional),
                                       ref_fleet.distributed_optimizer(opt,
                                                                       s))
        assert step._grad_comm_plan is not None  # the explicit wire ran
        x = Tensor(jnp.asarray(ids))
        losses = [float(np.asarray(raw(step(x, x)))) for _ in range(STEPS)]
        return dict(losses=losses, params={
            n: np.asarray(raw(p)) for n, p in m.named_parameters()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    gpt_batch, moe_batch, ids = _gpt_batch(), _moe_batch(), wire_ids()
    with no_mesh():
        states = {"gpt": numpy_state(_ref_gpt(None)),
                  "moe": numpy_state(_ref_moe())}
        paddle.seed(3)
        states["wire"] = numpy_state(wire_net(paddle))
    jobs = ([dict(name=n, model="gpt", **j) for n, j in GPT_JOBS.items()]
            + [dict(name="control", model="gpt", **CONTROL),
               dict(name="moe", kind="moe", model="moe", batch="moe",
                    **MOE_JOB),
               dict(name="wire", kind="wire_lamb", model="wire",
                    batch="wire", **WIRE_JOB)]
            + [dict(name=n, kind="zero3_hooks", model="gpt", **j)
               for n, j in sorted(HOOK_JOBS.items(), reverse=True)])
    out = tmp_path_factory.mktemp("lamb_fleet")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states,
                      dict(gpt=gpt_batch, moe=moe_batch, wire=ids))
    try:
        ref = {}
        gpt_args = [(gpt_batch["ids"].astype(np.int32),
                     gpt_batch["labels"].astype(np.int32))] * STEPS
        for name, job in GPT_JOBS.items():
            ref[name] = _ref_dist(job, lambda: _ref_gpt(states["gpt"]),
                                  lambda m, i, lab: m(i, labels=lab),
                                  gpt_args)
        moe_args = [(x.astype(np.int32), x.astype(np.int32))
                    for x in moe_batch["x"]]
        ref["moe"] = _ref_dist(MOE_JOB, lambda: _ref_moe(states["moe"]),
                               lambda m, i, lab: m(i, labels=lab), moe_args)
        ref["wire_train"] = _ref_wire_train(states["wire"], ids)
        ref["wire_dist"] = _ref_wire_dist(states["wire"], ids)
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref)


def _noisy_fraction(got, want):
    """The share of ``want``'s elements off by more than the tolerance;
    asserts every element within ``NOISE_BOUND``."""
    noisy = total = 0
    for n, w in want.items():
        d = np.abs(got[n] - w)
        assert d.max() <= NOISE_BOUND, (n, float(d.max()))
        noisy += int((d > PARAM_ATOL + PARAM_RTOL * np.abs(w)).sum())
        total += d.size
    return noisy / total


@pytest.mark.parametrize("name", sorted(GPT_JOBS))
def test_gpt_matches_reference(runs, name):
    want = runs["ref"][name]
    for r in range(WORLD):
        got = runs["port"][r][name]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert _noisy_fraction(got["full"], want["params"]) <= \
            MAX_NOISY_FRACTION, name
    assert want["inner"] == {"lamb": "Lamb", "lars": "Lars"}.get(
        GPT_JOBS[name].get("meta"), "AdamW")
    assert runs["port"][0][name]["losses"][-1] < \
        runs["port"][0][name]["losses"][0]


def test_shard_only_trust_ratio_misses_the_reference(runs):
    """The control: Lamb's norms of each rank's mp shard alone move the
    parameters past the tolerance (the gate above would catch it)."""
    got = runs["port"][0]["control"]
    assert _noisy_fraction(got["full"], runs["ref"]["lamb_dp2_mp2"][
        "params"]) > 10 * MAX_NOISY_FRACTION


def test_moe_experts_split_matches_reference(runs):
    want = runs["ref"]["moe"]
    assert want["inner"] == "Lamb"
    for r in range(WORLD):
        got = runs["port"][r]["moe"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert _noisy_fraction(got["full"], want["params"]) <= \
            MAX_NOISY_FRACTION
    # the experts were split: each rank held 4 of the 8
    assert {runs["port"][r]["moe"]["local"]["moe.w_in"].shape[0]
            for r in range(WORLD)} == {4}


def test_gradient_wire_keeps_whole_parameter_norms(runs):
    """The reference's explicit wire updates shard-shaped arrays: its Lamb
    misses its own TrainStep; the port's matches it."""
    train, dist = runs["ref"]["wire_train"], runs["ref"]["wire_dist"]
    assert _noisy_fraction(dist["params"], train["params"]) > \
        10 * MAX_NOISY_FRACTION
    for r in range(WORLD):
        got = runs["port"][r]["wire"]
        assert got["inner"] == "Lamb"
        np.testing.assert_allclose(got["losses"], train["losses"],
                                   rtol=LOSS_RTOL)
        assert _noisy_fraction(got["full"], train["params"]) <= \
            MAX_NOISY_FRACTION


def test_saved_tensors_hooks_inside_zero3_forward(runs):
    for r in range(WORLD):
        hooked, plain = runs["port"][r]["hooks"], runs["port"][r]["plain"]
        assert hooked["losses"] == plain["losses"]
        # the backward unpacks what it reads of what was packed
        assert hooked["counts"]["pack"] >= hooked["counts"]["unpack"] > 0
        assert hooked["alive"] and set(hooked["alive"]) == {0}
        assert hooked["regather"] > 0 and \
            hooked["regather"] == plain["regather"]


@pytest.mark.parametrize("kind", ["lars", "lamb-adam", "lamb-adamw",
                                  "neither"])
def test_meta_optimizer_swap_matches_reference(kind):
    """``distributed_optimizer`` swaps as the reference's does, carrying
    the rate, betas, clip and regularizer; the exclusions come from the
    configs."""
    def build(pkg, pkg_fleet, params):
        s = pkg_fleet.DistributedStrategy()
        if kind == "lars":
            s.lars = True
            s.lars_configs.update(lars_coeff=0.002, lars_weight_decay=1e-3,
                                  exclude_from_weight_decay=["b_"])
            opt = pkg.optimizer.Momentum(
                0.1, momentum=0.8, parameters=params,
                weight_decay=pkg.optimizer.L2Decay(1e-4),
                grad_clip=pkg.optimizer.ClipGradByNorm(1.0))
        elif kind.startswith("lamb"):
            s.lamb = True
            s.lamb_configs.update(lamb_weight_decay=0.02,
                                  exclude_from_weight_decay=["b_"])
            cls = (pkg.optimizer.Adam if kind == "lamb-adam"
                   else pkg.optimizer.AdamW)
            opt = cls(0.01, beta1=0.8, beta2=0.9, epsilon=1e-7,
                      parameters=params)
        else:
            s.lamb = True  # a Momentum is not Lamb's to swap
            opt = pkg.optimizer.Momentum(0.1, parameters=params)
        return pkg_fleet.distributed_optimizer(opt, s)._inner_opt

    with no_mesh():
        ref_fleet.init(is_collective=True,
                       strategy=ref_fleet.DistributedStrategy())
        ref_params = list(paddle.nn.Linear(4, 2).parameters())
        ref = build(paddle, ref_fleet, ref_params)
    import torch

    from paddle_tpu_torch.nn.layer import Parameter

    port_params = [Parameter(torch.zeros(4, 2)), Parameter(torch.zeros(2))]
    port = build(tp, fleet, port_params)
    assert type(port).__name__ == type(ref).__name__
    assert port._parameter_list == port_params
    for attr in ("_learning_rate", "_momentum", "_coeff", "_lars_wd",
                 "_epsilon", "_exclude", "_wd", "_beta1", "_beta2"):
        assert getattr(port, attr, None) == getattr(ref, attr, None), attr
    assert type(port._grad_clip).__name__ == type(ref._grad_clip).__name__
    assert type(port._regularizer).__name__ == \
        type(ref._regularizer).__name__
    if kind.startswith("lamb"):
        for name in ("w_0", "b_0"):
            assert port._exclude_fn(name) == ref._exclude_fn(name)


def test_wrapper_frees_with_its_references():
    """The split-sum hook the wrapper gives its inner optimizer holds the
    hybrid group, not the wrapper: dropping the wrapper, the optimizer and
    the model frees the parameters at once, with no garbage collection
    (a cycle kept a whole model alive between phases on the card)."""
    import gc
    import weakref

    import torch

    from paddle_tpu_torch.distributed.fleet.topology import (
        CommunicateTopology, HybridCommunicateGroup)

    topo = CommunicateTopology(("data", "pipe", "sharding", "sep", "model"),
                               (1, 1, 1, 1, 2))
    hcg = HybridCommunicateGroup(topo, global_rank=0)
    model = torch.nn.Linear(4, 4)
    alive = weakref.ref(model.weight)
    opt = fleet.HybridParallelOptimizer(
        tp.optimizer.Lamb(0.1, parameters=list(model.parameters())), hcg,
        fleet.DistributedStrategy())
    assert opt._inner_opt._split_sum is not None
    gc.disable()
    try:
        del opt, model
        assert alive() is None
    finally:
        gc.enable()
