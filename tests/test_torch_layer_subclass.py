"""The gate of ``nn.Layer``: models written the way Paddle users write
them, as ``paddle.nn.Layer`` subclasses, train on the port as they do on
the reference. The models are the reference's own test models:
``TinyLM`` (``tests/test_loss_parity.py``, here without ``fleet`` and
with ``F.scaled_dot_product_attention``, and with ``paddle.split`` /
``reshape`` / ``concat`` on the way) and ``SmallNet``
(``tests/test_inference.py``). Each is written once, built in both
packages, and the reference's weights are carried to the port through
numpy by structured name. Three AdamW steps through ``TrainStep`` and
through ``paddle.Model.fit`` give the same losses within ``rtol=1e-5``.
Also the repaired ``mean`` of integer and bool tensors."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.framework import load_numpy_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.functional import attention as tattn
from torch_port_utils import no_mesh

VOCAB, HIDDEN, HEADS = 61, 32, 2
B, SEQ, STEPS, LR = 2, 12, 3, 1e-3
# f32 losses of the same three steps on both sides: products and
# reductions in other orders
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's default device set to the CPU, restored after."""
    prev = tdevice._default
    T.set_device("cpu")
    yield
    tdevice._default = prev


def tiny_lm(paddle):
    """The reference tests' TinyLM, written against ``paddle``'s public
    API."""
    nn, F = paddle.nn, paddle.nn.functional
    d = HIDDEN // HEADS

    class TinyLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(VOCAB, HIDDEN)
            self.qkv = nn.Linear(HIDDEN, 3 * HIDDEN)
            self.out = nn.Linear(HIDDEN, VOCAB)

        def forward(self, ids, labels=None):
            h = self.emb(ids)
            b, t = ids.shape[0], ids.shape[1]
            q, k, v = paddle.split(self.qkv(h), 3, axis=-1)
            q, k, v = (paddle.reshape(x, [b, t, HEADS, d]) for x in (q, k, v))
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            heads = paddle.split(a, HEADS, axis=2)
            a = paddle.concat([paddle.reshape(x, [b, t, d]) for x in heads],
                              axis=-1)
            logits = self.out(a)
            if labels is None:
                return logits
            return F.cross_entropy(paddle.reshape(logits, [-1, VOCAB]),
                                   paddle.reshape(labels, [-1]))

    return TinyLM()


def small_net(paddle):
    nn = paddle.nn

    class SmallNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(16, 32)
            self.fc2 = nn.Linear(32, 4)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))

    return SmallNet()


def lm_loss(paddle):
    """The LM's loss as a layer, for ``Model.prepare``."""
    class LMLoss(paddle.nn.Layer):
        def forward(self, logits, labels):
            return paddle.nn.functional.cross_entropy(
                paddle.reshape(logits, [-1, VOCAB]),
                paddle.reshape(labels, [-1]))

    return LMLoss()


MODELS = {
    "TinyLM": (tiny_lm, lm_loss, lambda r: (
        r.integers(0, VOCAB, (B, SEQ)), r.integers(0, VOCAB, (B, SEQ)))),
    "SmallNet": (small_net, lambda p: p.nn.CrossEntropyLoss(), lambda r: (
        r.standard_normal((B, 16)).astype(np.float32),
        r.integers(0, 4, (B,)))),
}


def _pair(name):
    """The model in both packages, the port's carrying the reference's
    weights, and the numpy batches of three steps."""
    make = MODELS[name][0]
    with no_mesh():
        P.seed(7)
        ref = make(P)
    port = make(T)
    load_numpy_state(port, {k: np.asarray(raw(v))
                            for k, v in ref.state_dict().items()})
    rng = np.random.default_rng(5)
    batches = [MODELS[name][2](rng) for _ in range(STEPS)]
    return ref, port, batches


def _adamw(opt_mod, params):
    return opt_mod.AdamW(learning_rate=LR, parameters=params,
                         weight_decay=0.01)


def _ce(m, x, y):
    """SmallNet's loss on either package's tensors."""
    pkg = T if isinstance(x, torch.Tensor) else P
    return pkg.nn.functional.cross_entropy(m(x), y)


def _loss_fn(name):
    if name == "TinyLM":
        return lambda m, x, y: m(x, labels=y)
    return _ce


@pytest.mark.parametrize("name, flash", [("SmallNet", False),
                                         ("TinyLM", False), ("TinyLM", True)],
                         ids=["SmallNet", "TinyLM", "TinyLM-flash-route"])
def test_trainstep_trajectory(name, flash, monkeypatch):
    """With ``flash`` the port's attention runs the flash route (K1 / K2's
    plain versions on the CPU), as on the card."""
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU", flash)
    ref, port, batches = _pair(name)
    with no_mesh():
        step = RefTrainStep(ref, _loss_fn(name),
                            _adamw(P.optimizer, ref.parameters()))
        want = [float(np.asarray(raw(step(P.to_tensor(x), P.to_tensor(y)))))
                for x, y in batches]
    step = TrainStep(port, _loss_fn(name),
                     _adamw(T.optimizer, port.parameters()))
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


class _Batches:
    """The three steps' batches as samples, in order."""

    def __init__(self, batches):
        self.items = [(x[i], y[i]) for x, y in batches
                      for i in range(len(x))]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            loss = logs["loss"]
            self.losses.append(float(np.ravel(loss)[0]))

    return Recorder()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_fit_trajectory(name):
    ref, port, batches = _pair(name)
    losses = {}
    for key, pkg, net in (("ref", P, ref), ("port", T, port)):
        data = type("Data", (_Batches, pkg.io.Dataset), {})(batches)
        rec = _recorder(pkg.hapi.callbacks.Callback)
        with no_mesh():
            model = pkg.Model(net).prepare(
                _adamw(pkg.optimizer, net.parameters()),
                MODELS[name][1](pkg))
            model.fit(data, batch_size=B, epochs=1, shuffle=False,
                      verbose=0, callbacks=[rec])
        losses[key] = rec.losses
    assert len(losses["port"]) == STEPS
    np.testing.assert_allclose(losses["port"], losses["ref"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("dtype", ["int32", "int64", "bool"])
@pytest.mark.parametrize("axis, keepdim", [(None, False), (1, False),
                                           (0, True)],
                         ids=["all", "axis", "keepdim"])
def test_mean_of_integer_and_bool_tensors(dtype, axis, keepdim):
    """The repair: ``mean`` of an int32 / int64 / bool tensor is the
    reference's float32 mean (it raised on the port)."""
    x = np.random.default_rng(1).integers(0, 5, (3, 4)).astype(dtype)
    want = np.asarray(raw(P.mean(P.to_tensor(x), axis=axis,
                                 keepdim=keepdim)))
    got = T.mean(torch.from_numpy(x), axis=axis, keepdim=keepdim)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
