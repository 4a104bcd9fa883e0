"""The sep axis (context parallelism) of the PyTorch port against the
reference, at world size 4 on the CPU (gloo, one spawn running every job,
``file://`` rendezvous, joined under its own time limit).

``fleet.DistTrainStep`` at ``sep_degree > 1`` gives each rank its block of
the sequence; the attention runs as the ring over the sep group, the
default positions start at the block's first, the loss averages over data
x sep. Held against the reference on the same full weights and global
batches:

- the reference's sep ``TinyLM`` (its attention ``context_parallel_
  attention``) at sep 4, sep 2 (beside an idle mp 2), dp 2 x sep 2 and
  sharding 2 x sep 2 (ZeRO-1),
  against the reference's ``DistTrainStep`` at sep 1 and sep 2, within
  ``test_loss_parity._assert_parity``'s tolerance;
- the tiny GPT (the plain ring: its flash route takes ``_sdpa_reference``
  on CPU tensors) and Llama (GQA, RoPE; the kernels' route on their plain
  versions) at 4 layers, dp 2 x sep 2 and mp 2 + SP x sep 2, against the
  reference's ``TrainStep``: losses within 1e-5 as ``test_torch_fleet.py``,
  the gathered parameters by its rule;
- ``LongContextLM`` of ``examples/train_long_context.py`` at its widths,
  the sequence cut to 128, at dp 2 x sep 2 against the reference's
  ``TrainStep``;
- a mask or attention dropout under the split raises."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu.text.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.distributed.env import Group
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import ring_attention as ra

from torch_port_utils import (FLEET_LR, LONG_CONTEXT, fleet_adamw,
                              fleet_jobs, join_ranks, long_context_lm,
                              no_mesh, numpy_state, sep_tiny_lm, spawn_ranks,
                              tiny_gpt_kwargs, tiny_llama_kwargs)

WORLD = 4
STEPS = 3
LAYERS = 4
# test_loss_parity._assert_parity's tolerance (the reference's own sep 2
# against sep 1)
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-5
# f32 on both sides, the ring's merge order against one softmax
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * FLEET_LR * STEPS
MAX_NOISY_FRACTION = 0.01

# sep 2 alone takes the mp axis (idle: TinyLM has no mp layers) to fill
# the world of 4
TINY_CONFIGS = {"sep4": dict(dp=1, sep=4), "mp2_sep2": dict(dp=1, mp=2, sep=2),
                "dp2_sep2": dict(dp=2, sep=2),
                "sh2_sep2": dict(dp=1, sharding=2, sep=2)}
MODEL_CONFIGS = {"dp2_sep2": dict(dp=2, sep=2),
                 "mp2_sp_sep2": dict(dp=1, mp=2, sp=True, sep=2)}
MODELS = ("gpt", "llama")
LONG_SEQ = 128


def _token_batches(vocab, shape, seed):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(0, vocab, shape) for _ in range(STEPS)]
    return dict(ids=ids, labels=ids)


def _model_batches():
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 64, (4, 16))
    labels = rng.integers(0, 64, (4, 16))
    llama_labels = labels.copy()
    llama_labels[0, :13] = -100      # ignored labels, unevenly by block
    llama_labels[3, 9:] = -100
    return {"gpt": dict(ids=ids, labels=labels),
            "llama": dict(ids=ids, labels=llama_labels)}


def _ref_model(kind):
    paddle.seed(7)
    if kind == "gpt":
        m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(
            vocab_size=64, num_hidden_layers=LAYERS)))
    else:
        m = LlamaForCausalLM(LlamaConfig(**tiny_llama_kwargs(
            vocab_size=64, num_hidden_layers=LAYERS)))
    m.eval()
    return m


def _ref_user(build, seed):
    paddle.seed(seed)
    return build(paddle)


def _args(*arrays):
    return [Tensor(jnp.asarray(a.astype(np.int32))) for a in arrays]


def _ref_trajectory(model, batches, step_of, repeat=None):
    opt = fleet_adamw(model.parameters(), paddle.optimizer,
                      paddle.nn.ClipGradByGlobalNorm)
    step = step_of(model, opt)
    pairs = ([(batches["ids"], batches["labels"])] * STEPS if repeat
             else list(zip(batches["ids"], batches["labels"])))
    losses = [float(np.asarray(raw(step(*_args(i, lab)))))
              for i, lab in pairs]
    return losses, {n: np.asarray(raw(p)) for n, p in
                    model.named_parameters()}


def _train_step(m, opt):
    return RefTrainStep(m, lambda mm, i, lab: mm(i, labels=lab), opt)


def _ref_dist_user(build, seed, batches, sep):
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, sep_degree=sep)
        ref_fleet.init(is_collective=True, strategy=s)
        m = _ref_user(build, seed)

        def step_of(model, opt):
            model = ref_fleet.distributed_model(model)
            return ref_fleet.DistTrainStep(
                model, lambda mm, i, lab: mm(i, labels=lab),
                ref_fleet.distributed_optimizer(opt))
        return _ref_trajectory(m, batches, step_of)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's jobs (one spawn of WORLD ranks) and the reference's
    trajectories, computed while the ranks run."""
    tiny_batches = _token_batches(64, (8, 16), 42)
    long_batches = _token_batches(LONG_CONTEXT["vocab"], (2, LONG_SEQ), 0)
    model_batches = _model_batches()
    with no_mesh():
        states = {k: numpy_state(_ref_model(k)) for k in MODELS}
        states["sep_tiny_lm"] = numpy_state(_ref_user(sep_tiny_lm, 77))
        states["long_context_lm"] = numpy_state(
            _ref_user(long_context_lm, 11))
    batches = dict(model_batches, sep_tiny_lm=tiny_batches,
                   long_context_lm=long_batches)
    jobs = ([dict(name=f"tiny_{c}", kind="user_lm", model="sep_tiny_lm",
                  **kw) for c, kw in TINY_CONFIGS.items()]
            + [dict(name=f"{m}_{c}", model=m,
                    config=dict(num_hidden_layers=LAYERS), **kw)
               for m in MODELS for c, kw in MODEL_CONFIGS.items()]
            + [dict(name="long_dp2_sep2", kind="user_lm",
                    model="long_context_lm", dp=2, sep=2)])
    out = tmp_path_factory.mktemp("sep")
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, states, batches)
    try:
        ref = {"tiny_sep1": _ref_dist_user(sep_tiny_lm, 77, tiny_batches, 1),
               "tiny_sep2": _ref_dist_user(sep_tiny_lm, 77, tiny_batches, 2)}
        with no_mesh():
            for m in MODELS:
                ref[m] = _ref_trajectory(_ref_model(m), model_batches[m],
                                         _train_step, repeat=True)
            ref["long"] = _ref_trajectory(_ref_user(long_context_lm, 11),
                                          long_batches, _train_step)
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref)


def _assert_params_close(got, want):
    noisy = total = 0
    for n, w in want.items():
        d = np.abs(got[n] - w)
        assert d.max() <= NOISE_BOUND, (n, d.max())
        noisy += int((d > PARAM_ATOL).sum())
        total += d.size
    assert noisy <= MAX_NOISY_FRACTION * total, (noisy, total)


def _same_on_every_rank(runs, name, sep, attentions):
    """The losses, equal on every rank, after checking that each rank
    rotated its ring as often as ``attentions`` attention calls a step
    take on either route: the plain ring's autograd steps back once per
    step forward; the kernels' backward keeps the blocks it received and
    sends only their dK / dV back, as many hops."""
    per_call = 2 * (sep - 1)
    losses = runs["port"][0][name]["losses"]
    for r in range(WORLD):
        res = runs["port"][r][name]
        assert res["losses"] == losses
        assert res["counts"].get("batch_isend_irecv", 0) == \
            per_call * attentions * STEPS, (r, res["counts"])
    return losses


@pytest.mark.parametrize("against", ["tiny_sep1", "tiny_sep2"])
@pytest.mark.parametrize("config", list(TINY_CONFIGS))
def test_tiny_lm_matches_reference_dist_train_step(runs, config, against):
    losses = _same_on_every_rank(runs, f"tiny_{config}",
                                 TINY_CONFIGS[config]["sep"], 1)
    want, _ = runs["ref"][against]
    np.testing.assert_allclose(losses, want, rtol=PARITY_RTOL,
                               atol=PARITY_ATOL)
    assert losses[-1] < losses[0]


def test_reference_sep2_is_its_sep1(runs):
    """The yardstick: the reference's own sep parity claim on this file's
    batches (its DistTrainStep at sep 2 against sep 1)."""
    a, _ = runs["ref"]["tiny_sep1"]
    b, _ = runs["ref"]["tiny_sep2"]
    np.testing.assert_allclose(b, a, rtol=PARITY_RTOL, atol=PARITY_ATOL)


@pytest.mark.parametrize("config", list(MODEL_CONFIGS))
@pytest.mark.parametrize("model", MODELS)
def test_model_matches_reference_train_step(runs, model, config):
    name = f"{model}_{config}"
    # GPT's flash route on CPU tensors is the dense one, so its ring is the
    # plain version; Llama's flash attention runs the kernels' route
    losses = _same_on_every_rank(runs, name, MODEL_CONFIGS[config]["sep"],
                                 LAYERS)
    want, final = runs["ref"][model]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    _assert_params_close(runs["port"][0][name]["full"], final)


def test_long_context_example_matches_reference(runs):
    losses = _same_on_every_rank(runs, "long_dp2_sep2", 2, 1)
    want, final = runs["ref"]["long"]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _assert_params_close(runs["port"][0]["long_dp2_sep2"]["full"], final)


@pytest.mark.parametrize("what", ["bool mask", "float mask", "dropout"])
def test_masked_attention_under_the_split_raises(what, monkeypatch):
    """Masks and dropout ride the split now (``test_torch_sep_mask.py``
    holds them against the reference): a mask in neither split layout (a
    ``[T_local, T_local]`` one) raises ``ValueError`` naming the layouts,
    and dropout takes the plain ring even with the flash route asked
    for."""
    from paddle_tpu_torch.nn.functional import attention

    q = torch.zeros((1, 4, 2, 8))
    if what == "dropout":
        seen = []
        monkeypatch.setattr(ra, "ring_flash_attention_plain",
                            lambda *a: seen.append(a[4:]) or q)
        monkeypatch.setattr(attention, "_FLASH_ON_CPU", True)
        with ra.sequence_split(Group([0, 1])):
            F.scaled_dot_product_attention(q, q, q, is_causal=True,
                                           dropout_p=0.1, training=True)
        assert seen == [(True, None, None, 0.1)]
        return
    mask = {"bool mask": torch.ones((4, 4), dtype=torch.bool),
            "float mask": torch.zeros((4, 4))}[what]
    with ra.sequence_split(Group([0, 1])):
        with pytest.raises(ValueError, match="sequence split of 2 blocks"):
            F.scaled_dot_product_attention(q, q, q, is_causal=True,
                                           attn_mask=mask)
