"""``fold_layers=True`` on the port's GPT, Llama, BERT and ERNIE (tiny, 4
layers) against the reference.

The fold is a one-stage ``SpmdPipeline``: its blocks run in order, and its
``state_dict`` holds the reference's stacked layout. On the same weights
its forward and a 3-step AdamW ``TrainStep`` trajectory (clip 1.0) match
the reference's unfolded model (the reference's own
``tests/test_gpt_fold_layers.py`` pins its folded model to its unfolded
one; its folded compiles are marked slow there, so the reference side
here is unfolded). The checkpoints go both ways with the reference's
folded model, built but not run: the same keys, the same values."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.fleet.meta_parallel import SpmdPipeline
from paddle_tpu_torch.framework.io_state import load_numpy_state
from paddle_tpu_torch.jit import TrainStep

from torch_port_utils import (FLEET_LR, VOCAB, encoder_batch, fleet_adamw,
                              from_stacked, jax_tiny_encoder, jax_tiny_gpt,
                              jax_tiny_llama, numpy_state, tiny_encoder_kwargs,
                              tiny_gpt_kwargs, tiny_llama_kwargs, to_stacked)

LAYERS = 4
STEPS = 3
# f32 through four blocks and the head on both sides (matmul and reduction
# orders differ by ulps)
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5
# the fleet trajectories' rule: every element within Adam's noise bound,
# all but 1 % within PARAM_ATOL
PARAM_ATOL = 1e-5
NOISE_BOUND = 2 * FLEET_LR * STEPS
HEADS = {"bert": "BertForSequenceClassification",
         "ernie": "ErnieForSequenceClassification"}


def _ref(kind, seed=7, **kw):
    if kind == "gpt":
        return jax_tiny_gpt(seed, num_hidden_layers=LAYERS, **kw)
    if kind == "llama":
        return jax_tiny_llama(seed, num_hidden_layers=LAYERS, **kw)
    return jax_tiny_encoder(kind, HEADS[kind], seed,
                            num_hidden_layers=LAYERS, **kw)


def _port(kind, fold=True, seed=0):
    if kind == "gpt":
        from paddle_tpu_torch.text.models.gpt import GPTConfig as C
        from paddle_tpu_torch.text.models.gpt import GPTForCausalLM as M

        return M(C(**tiny_gpt_kwargs(num_hidden_layers=LAYERS,
                                     fold_layers=fold)), device="cpu",
                 seed=seed)
    if kind == "llama":
        from paddle_tpu_torch.text.models.llama import LlamaConfig as C
        from paddle_tpu_torch.text.models.llama import LlamaForCausalLM as M

        return M(C(**tiny_llama_kwargs(num_hidden_layers=LAYERS,
                                       fold_layers=fold)), device="cpu",
                 seed=seed)
    import importlib

    mod = importlib.import_module(f"paddle_tpu_torch.text.models.{kind}")
    cfg = getattr(mod, f"{kind.capitalize()}Config")(**tiny_encoder_kwargs(
        kind, num_hidden_layers=LAYERS, fold_layers=fold))
    return getattr(mod, HEADS[kind])(cfg, num_classes=3, device="cpu",
                                     seed=seed)


def _stack(model):
    return {"gpt": lambda m: m.gpt.decoder,
            "llama": lambda m: m.llama.layers,
            "bert": lambda m: m.bert.encoder,
            "ernie": lambda m: m.ernie.encoder}[_kind(model)](model)


def _kind(model):
    return type(model).__module__.rsplit(".", 1)[1]


def _batch(kind):
    if kind in ("gpt", "llama"):
        rng = np.random.default_rng(13)
        return (rng.integers(0, VOCAB, (2, 16)),
                rng.integers(0, VOCAB, (2, 16)))
    ids, types, mask = encoder_batch(b=4, t=10, seed=3, kind=kind)
    return ids, types, mask, np.random.default_rng(3).integers(0, 3, (4,))


def _loss_fn(kind):
    if kind in ("gpt", "llama"):
        return lambda m, ids, lab: m(ids, labels=lab)
    return lambda m, ids, types, mask, lab: m(ids, types, attention_mask=mask,
                                              labels=lab)


def _forward(kind, model, batch, wrap):
    if kind in ("gpt", "llama"):
        return model(wrap(batch[0]))
    ids, types, mask, _ = batch
    return model(wrap(ids), wrap(types), attention_mask=wrap(mask))


def _to_jax(x):
    return Tensor(jnp.asarray(x))


MODELS = ["gpt", "llama", "bert", "ernie"]


@pytest.mark.parametrize("kind", MODELS)
def test_forward_matches_reference_unfolded(kind):
    batch = _batch(kind)
    with _ref(kind) as jm:
        state = numpy_state(jm)
        want = np.asarray(raw(_forward(kind, jm, batch, _to_jax)))
    fold, plain = _port(kind), _port(kind, fold=False)
    assert isinstance(_stack(fold), SpmdPipeline)
    load_numpy_state(fold, to_stacked(fold, state))
    load_numpy_state(plain, state)
    with torch.no_grad():
        got = _forward(kind, fold, batch, torch.from_numpy)
        # the fold runs the same blocks in the same order: bit-equal
        assert torch.equal(got, _forward(kind, plain, batch,
                                         torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("kind", MODELS)
def test_train_step_trajectory_matches_reference_unfolded(kind):
    batch = _batch(kind)
    loss_fn = _loss_fn(kind)
    with _ref(kind) as jm:
        state = numpy_state(jm)
        opt = fleet_adamw(jm.parameters(), paddle.optimizer,
                          paddle.nn.ClipGradByGlobalNorm)
        ref = RefTrainStep(jm, loss_fn, opt)
        want = [float(np.asarray(raw(ref(*map(_to_jax, batch)))))
                for _ in range(STEPS)]
        want_params = {n: np.asarray(raw(p)) for n, p in jm.named_parameters()}
    tm = load_numpy_state(_port(kind), to_stacked(_port(kind), state))
    step = TrainStep(tm, loss_fn, fleet_adamw(
        tm.parameters(), topt, topt.ClipGradByGlobalNorm))
    got = [float(step(*map(torch.from_numpy, batch))) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    full = from_stacked(tm, {k: v.numpy() for k, v in tm.state_dict().items()})
    far = total = 0
    for n, w in want_params.items():
        d = np.abs(full[n] - w)
        assert d.max() <= NOISE_BOUND, n
        far += int((d > PARAM_ATOL).sum())
        total += d.size
    assert far <= 0.01 * total


@pytest.mark.parametrize("kind", MODELS)
def test_state_dict_interchange_with_reference_folded(kind):
    """Reference folded -> port folded, and port folded -> reference
    folded: the same keys (the stacked ``__`` names, Llama's RoPE tables as
    ``*_stacked`` buffers), the same values."""
    with _ref(kind, fold_layers=True) as jm:
        ref_state = numpy_state(jm)
    tm = load_numpy_state(_port(kind, seed=1), ref_state)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sorted(got) == sorted(ref_state)
    for k, v in ref_state.items():
        assert np.array_equal(got[k], v), k
    if kind == "llama":
        assert "llama.layers.self_attn__rope_cos_stacked" in got

    port_state = {k: v.numpy()
                  for k, v in _port(kind, seed=2).state_dict().items()}
    with _ref(kind, seed=9, fold_layers=True) as jm:
        jm.set_state_dict({k: _to_jax(v) for k, v in port_state.items()})
        back = numpy_state(jm)
    assert sorted(back) == sorted(port_state)
    for k, v in port_state.items():
        assert np.array_equal(back[k], v), k
