"""BERT and ERNIE of the PyTorch port (``paddle_tpu_torch/text/models/
bert.py``, ``ernie.py``) against the reference on bridged weights, at the
tiny size of ``torch_port_utils.tiny_encoder_kwargs`` (2 layers, hidden
32, head_dim 8, dropouts 0): state names and shapes of every head class,
logits under a padding mask with varied lengths on both attention routes
(the dense ``_sdpa_reference`` and the flash route's plain versions, the
bias taking no gradient), the masked-LM loss with ``ignore_index`` and
its gradients, a 3-step ``TrainStep`` + ``AdamW`` trajectory, and the
unpadded positions' independence of the padding."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text.models import bert as tbert
from paddle_tpu_torch.text.models import ernie as ternie

from torch_port_utils import (ENCODER_HEADS, VOCAB, encoder_batch,
                              jax_tiny_encoder, numpy_state,
                              tiny_encoder_kwargs, torch_tiny_encoder)

# f32 logits through two post-LN blocks: matmul and reduction orders
# differ by ulps of values of O(1)
LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-5
# f32 gradients: a few ulps of the largest, relative to it
GRAD_TOL = 1e-5
LR = 1e-3
STEPS = 3
# Adam moves an element by about lr * sign(g): an element whose gradient
# is float noise on both sides may drift by up to 2 * lr a step (see
# test_torch_train.py); all but 1 % within PARAM_ATOL
PARAM_ATOL = 1e-5

HEADS = [(kind, head) for kind, heads in ENCODER_HEADS.items()
         for head in heads]


def _ids(head):
    return [f"{kind}-{head}" for kind, head in head]


@pytest.fixture(params=["sdpa_reference", "flash_plain"])
def route(request, monkeypatch):
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU",
                        request.param == "flash_plain")
    return request.param


def _ref_out(jm, ids, types, mask, **kw):
    out = jm(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(types)),
             attention_mask=Tensor(jnp.asarray(mask)), **kw)
    return out[0] if isinstance(out, tuple) else out


def _port_out(tm, ids, types, mask, **kw):
    out = tm(torch.from_numpy(ids), torch.from_numpy(types),
             attention_mask=torch.from_numpy(mask), **kw)
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("kind, head", HEADS, ids=_ids(HEADS))
def test_state_names_and_shapes_match(kind, head):
    with jax_tiny_encoder(kind, head) as jm:
        state = numpy_state(jm)
    tm = torch_tiny_encoder(state, kind, head)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == {k: v.shape for k, v in state.items()}
    # the tied head adds no second copy of the word embeddings
    assert not any("_tied" in k for k in got)
    # parameter order (the optimizer's state positions) is the reference's
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]


@pytest.mark.parametrize("kind, head", HEADS, ids=_ids(HEADS))
def test_logits_match_reference(kind, head, route):
    ids, types, mask = encoder_batch()
    with jax_tiny_encoder(kind, head) as jm:
        want = np.asarray(raw(_ref_out(jm, ids, types, mask)))
        tm = torch_tiny_encoder(numpy_state(jm), kind, head)
    before = fa.launches_fwd
    with torch.no_grad():
        got = _port_out(tm, ids, types, mask).numpy()
    assert fa.launches_fwd == before  # plain versions on the CPU
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def _mlm_labels(ids, mask, seed=9):
    rng = np.random.default_rng(seed)
    labels = np.where((rng.random(ids.shape) < 0.3) & (mask > 0), ids, -100)
    labels[0, 0] = ids[0, 0]  # at least one label
    return labels


@pytest.mark.parametrize("kind", ["bert", "ernie"])
def test_mlm_loss_and_grads_match_reference(kind, route):
    head = ENCODER_HEADS[kind][1]
    ids, types, mask = encoder_batch(seed=6)
    labels = _mlm_labels(ids, mask)
    with jax_tiny_encoder(kind, head) as jm:
        tm = torch_tiny_encoder(numpy_state(jm), kind, head)
        loss = jm(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(types)),
                  attention_mask=Tensor(jnp.asarray(mask)),
                  labels=Tensor(jnp.asarray(labels)))
        loss.backward()
        want_loss = float(np.asarray(raw(loss)))
        want = {n: np.asarray(raw(p.grad)) for n, p in jm.named_parameters()}
    got_loss = _port_out(tm, ids, types, mask,
                         labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=LOSS_RTOL)
    got_loss.backward()
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    scale = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        err = np.abs(named[n].grad.numpy() - g).max()
        assert err <= GRAD_TOL * scale, (route, n, err)


def _cls_batch(seed=3):
    ids, types, mask = encoder_batch(b=4, t=10, seed=seed)
    labels = np.random.default_rng(seed).integers(0, 3, (4,))
    return ids, types, mask, labels


def test_adamw_trajectory_matches_reference(route):
    kind, head = "ernie", "ErnieForSequenceClassification"
    batch = _cls_batch()

    def loss_fn(model, ids, types, mask, labels):
        return model(ids, types, attention_mask=mask, labels=labels)

    with jax_tiny_encoder(kind, head, train=True) as jm:
        tm = torch_tiny_encoder(numpy_state(jm), kind, head)
        ref = RefTrainStep(jm, loss_fn, paddle.optimizer.AdamW(
            learning_rate=LR, parameters=jm.parameters(),
            weight_decay=0.01))
        want = [float(np.asarray(raw(ref(*(Tensor(jnp.asarray(x))
                                           for x in batch)))))
                for _ in range(STEPS)]
        want_params = {n: np.asarray(raw(p))
                       for n, p in jm.named_parameters()}
    step = TrainStep(tm, loss_fn, topt.AdamW(
        learning_rate=LR, parameters=tm.parameters(), weight_decay=0.01))
    got = [float(step(*(torch.from_numpy(x) for x in batch)))
           for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    far = total = 0
    for n, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want_params[n])
        assert d.max() <= 2 * LR * STEPS, n
        far += int((d > PARAM_ATOL).sum())
        total += d.size
    assert far <= 0.01 * total


@pytest.mark.parametrize("kind", ["bert", "ernie"])
def test_padding_leaves_unpadded_positions_alone(kind, route):
    """Each row run alone at its own length gives the hidden states the
    padded batch gives at that row's kept positions."""
    head = ENCODER_HEADS[kind][0]
    ids, types, mask = encoder_batch(b=3, t=12, seed=8)
    with jax_tiny_encoder(kind, head) as jm:
        tm = torch_tiny_encoder(numpy_state(jm), kind, head)
    with torch.no_grad():
        padded = _port_out(tm, ids, types, mask).numpy()
        for i, n in enumerate(mask.sum(1)):
            alone = _port_out(tm, ids[i:i + 1, :n], types[i:i + 1, :n],
                              mask[i:i + 1, :n]).numpy()
            np.testing.assert_allclose(padded[i, :n], alone[0], rtol=0,
                                       atol=LOGIT_ATOL)
    # the padded positions do see a different input (the check is live)
    assert mask.min() == 0


def test_mask_is_the_reference_additive_mask():
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]])
    got = tbert.padding_mask(mask)
    assert got.shape == (2, 1, 1, 3) and got.dtype == torch.float32
    assert got[0, 0, 0].tolist() == [0.0, 0.0, -1e9]


@pytest.mark.parametrize("cfg", [tbert.BertConfig, ternie.ErnieConfig])
def test_fold_layers_raises(cfg):
    """``fold_layers`` raised until the fold was ported (ROADMAP §A.3, now
    done): the config takes it, and the encoder is the one-stage fold
    (tests/test_torch_fold_layers.py holds it against the reference)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import SpmdPipeline

    config = cfg(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=32, vocab_size=32, fold_layers=True)
    model = (tbert.BertModel if cfg is tbert.BertConfig
             else ternie.ErnieModel)(config, device="cpu")
    assert config.fold_layers and isinstance(model.encoder, SpmdPipeline)


def test_encoder_takes_the_flash_route_with_the_padding_bias(monkeypatch):
    """On the flash route each layer calls the flash attention once,
    non-causal, with the [b, 1, 1, t] mask as a bias that takes no
    gradient; with attention dropout active in training it takes the
    dense route instead."""
    calls = []
    real = tattn._fa.flash_attention

    def spy(q, k, v, causal=False, scale=None, bias=None, mask=None,
            bias_needs_grad=True):
        calls.append((causal, None if bias is None else tuple(bias.shape),
                      bias_needs_grad, q.shape[-1]))
        return real(q, k, v, causal=causal, scale=scale, bias=bias,
                    mask=mask, bias_needs_grad=bias_needs_grad)

    monkeypatch.setattr(tattn, "_FLASH_ON_CPU", True)
    monkeypatch.setattr(tattn._fa, "flash_attention", spy)
    ids, types, mask = encoder_batch(b=2, t=9)
    cfg = ternie.ErnieConfig(**tiny_encoder_kwargs(
        attention_probs_dropout_prob=0.1))
    m = ternie.ErnieForSequenceClassification(cfg, device="cpu")
    m.eval()
    _port_out(m, ids, types, mask)
    assert calls == [(False, (2, 1, 1, 9), False, 8)] * 2
    calls.clear()
    m.train()
    _port_out(m, ids, types, mask)
    assert calls == []
