"""``paddle.Model`` of the PyTorch port (``paddle_tpu_torch/hapi_model.py``,
``hapi/callbacks.py``) against the reference's on a tiny ERNIE sequence
classifier (``torch_port_utils``, dropouts 0) with bridged weights and the
same numpy data and seed: ``fit``'s per-step losses (AdamW under a warmup
schedule stepped by the ``LRScheduler`` callback), the callback events,
``evaluate``'s loss and accuracy, ``predict``'s outputs, and checkpoints
saved by either package loaded by the other. Then the callbacks alone,
``ParamAttr``'s learning rate and regularizer against the reference's
``functional_update``, and what the port refuses."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import io as rio
from paddle_tpu import metric as rmetric
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu.hapi import callbacks as rcb
from paddle_tpu.optimizer import lr as rlr
from paddle_tpu_torch import Model, io as tio, metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.optimizer import lr as tlr

from torch_port_utils import (VOCAB, jax_tiny_encoder, no_mesh, numpy_state,
                              torch_tiny_encoder)

HEAD = "ErnieForSequenceClassification"
# f32 losses of the same steps: two post-LN blocks, AdamW, other orders
LOSS_RTOL = 2e-5
OUT_ATOL = 2e-5
T, N, BATCH = 12, 12, 4


class Pairs:
    """(ids, token types, keep-mask, label) samples as a tokenizer pads
    them to T, the label a learnable function of the tokens."""

    def __init__(self, n=N, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            real = int(rng.integers(4, T + 1))
            ids = np.zeros(T, np.int64)
            ids[:real] = rng.integers(1, VOCAB, real)
            types = np.zeros(T, np.int64)
            types[real // 2:real] = 1
            mask = (np.arange(T) < real).astype(np.int64)
            label = np.int64(ids[0] % 3)
            self.items.append((ids, types, mask, label))

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _ds(io_mod, seed=0):
    return type("Data", (Pairs, io_mod.Dataset), {})(seed=seed)


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.events, self.losses = [], []

        def on_train_begin(self, logs=None):
            self.events.append(("train_begin",))

        def on_train_end(self, logs=None):
            self.events.append(("train_end", sorted(logs or {})))

        def on_epoch_begin(self, epoch, logs=None):
            self.events.append(("epoch_begin", epoch))

        def on_epoch_end(self, epoch, logs=None):
            self.events.append(("epoch_end", epoch, sorted(logs or {})))

        def on_train_batch_begin(self, step, logs=None):
            self.events.append(("batch_begin", step))

        def on_train_batch_end(self, step, logs=None):
            self.events.append(("batch_end", step))
            self.losses.append(logs["loss"])

    return Recorder()


def _schedule(lr_mod):
    return lr_mod.LinearWarmup(1e-3, warmup_steps=3, start_lr=1e-4,
                               end_lr=1e-3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``fit`` (2 epochs of 3 steps, eval each epoch),
    ``evaluate`` and ``predict`` from the same weights, and each one's
    checkpoint after training."""
    tmp = tmp_path_factory.mktemp("hapi")
    with jax_tiny_encoder("ernie", HEAD, train=True) as jm:
        tnet = torch_tiny_encoder(numpy_state(jm), "ernie", HEAD)
        ref_sched = _schedule(rlr)
        ref = paddle.Model(jm).prepare(
            paddle.optimizer.AdamW(learning_rate=ref_sched,
                                   parameters=jm.parameters(),
                                   weight_decay=0.01),
            rnn.CrossEntropyLoss(), rmetric.Accuracy())
        ref_rec = _recorder(rcb.Callback)
        np.random.seed(3)
        ref.fit(_ds(rio), _ds(rio, 1), batch_size=BATCH, epochs=2,
                verbose=0, callbacks=[ref_rec])
        ref_eval = ref.evaluate(_ds(rio, 2), batch_size=BATCH, verbose=0)
        ref_pred = ref.predict(_ds(rio, 2), batch_size=BATCH,
                               stack_outputs=True)[0]
        ref.save(str(tmp / "ref"))
        ref_lr = ref_sched()
        ref_params = numpy_state(jm)
        ref_opt = _np_state(ref._optimizer.state_dict())
    port_sched = _schedule(tlr)
    port = Model(tnet).prepare(
        topt.AdamW(learning_rate=port_sched, parameters=tnet.parameters(),
                   weight_decay=0.01),
        tnn.CrossEntropyLoss(), tmetric.Accuracy())
    port_rec = _recorder(tcb.Callback)
    np.random.seed(3)
    port.fit(_ds(tio), _ds(tio, 1), batch_size=BATCH, epochs=2, verbose=0,
             callbacks=[port_rec])
    port_eval = port.evaluate(_ds(tio, 2), batch_size=BATCH, verbose=0)
    port_pred = port.predict(_ds(tio, 2), batch_size=BATCH,
                             stack_outputs=True)[0]
    port.save(str(tmp / "port"))
    return dict(tmp=tmp, ref_rec=ref_rec, port_rec=port_rec,
                ref_params=ref_params, ref_opt=ref_opt,
                port_params={k: v.detach().clone().numpy()
                             for k, v in tnet.state_dict().items()},
                port_opt=_np_state(port._optimizer.state_dict()),
                ref_eval=ref_eval, port_eval=port_eval, ref_pred=ref_pred,
                port_pred=port_pred, ref_lr=ref_lr, port_lr=port_sched())


def test_fit_losses_match_reference(runs):
    want, got = runs["ref_rec"].losses, runs["port_rec"].losses
    assert len(got) == len(want) == 2 * N // BATCH
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.mean(got[-3:]) < np.mean(got[:3])
    # the LRScheduler callback stepped the schedule once a batch
    assert runs["port_lr"] == runs["ref_lr"] == 1e-3


def test_callback_events_match_reference(runs):
    got, want = runs["port_rec"].events, runs["ref_rec"].events
    assert got == want
    assert ("epoch_end", 1, ["batch_size", "eval_acc", "eval_loss",
                             "loss"]) in got


def test_evaluate_and_predict_match_reference(runs):
    got, want = runs["port_eval"], runs["ref_eval"]
    assert got.keys() == want.keys() == {"loss", "acc"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["acc"] == want["acc"]
    assert 0.0 <= got["acc"] <= 1.0
    assert runs["port_pred"].shape == runs["ref_pred"].shape == (N, 3)
    np.testing.assert_allclose(runs["port_pred"], runs["ref_pred"], rtol=0,
                               atol=OUT_ATOL)


def _np_state(state):
    return {k: (v if k == "LR_Scheduler" else
                np.asarray(raw(v)) if not isinstance(v, torch.Tensor)
                else v.numpy()) for k, v in state.items()}


def _assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "LR_Scheduler":
            assert got[k] == v
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoints_interchange(runs):
    """Each package's ``.pdparams`` / ``.pdopt`` loads into the other: the
    parameters, the optimizer's moments and the scheduler's state arrive
    bit for bit."""
    tmp = runs["tmp"]
    with jax_tiny_encoder("ernie", HEAD) as jm:
        tnet = torch_tiny_encoder(numpy_state(jm), "ernie", HEAD)
        for p in jm.parameters():
            p._rebind(jnp.zeros_like(raw(p)))
        ref_opt = paddle.optimizer.AdamW(learning_rate=_schedule(rlr),
                                         parameters=jm.parameters())
        ref = paddle.Model(jm).prepare(ref_opt, rnn.CrossEntropyLoss())
        ref.load(str(tmp / "port"))
        ref_params = numpy_state(jm)
        ref_state = _np_state(ref_opt.state_dict())
    port_opt = topt.AdamW(learning_rate=_schedule(tlr),
                          parameters=tnet.parameters())
    port = Model(tnet).prepare(port_opt, tnn.CrossEntropyLoss())
    port.load(str(tmp / "ref"))
    port_params = {k: v.numpy() for k, v in tnet.state_dict().items()}
    _assert_states_equal(ref_params, runs["port_params"])
    _assert_states_equal(port_params, runs["ref_params"])
    _assert_states_equal(ref_state, runs["port_opt"])
    _assert_states_equal(_np_state(port_opt.state_dict()), runs["ref_opt"])
    assert any(k.endswith(".moment2") for k in ref_state)
    assert ref_state["LR_Scheduler"]["last_epoch"] == 6


def test_save_load_round_trip_keeps_dtypes(tmp_path):
    from paddle_tpu_torch.framework import io_state

    state = {"w": torch.randn(3, 2), "h": torch.randn(4).bfloat16(),
             "n": {"step": 3, "t": [torch.arange(2)]}}
    io_state.save(state, str(tmp_path / "s.pdparams"))
    back = io_state.load(str(tmp_path / "s.pdparams"), device="cpu")
    assert torch.equal(back["w"], state["w"])
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"], state["h"])
    assert back["n"]["step"] == 3 and back["n"]["t"][0].tolist() == [0, 1]
    raw_np = io_state.load(str(tmp_path / "s.pdparams"), return_numpy=True)
    assert isinstance(raw_np["w"], np.ndarray)
    # the reference reads the bf16 entry in its own dtype
    ref = paddle.load(str(tmp_path / "s.pdparams"))
    assert str(raw(ref["h"]).dtype) == "bfloat16"


def _small_model(seed=0):
    torch.manual_seed(seed)
    net = torch.nn.Sequential(tnn.Linear(4, 3, device="cpu"))
    return net


class Blobs(tio.Dataset):
    def __init__(self, n=16, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 4)).astype(np.float32)
        self.y = (self.x[:, 0] > 0).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.y)


def _prepared(lr=0.1):
    net = _small_model()
    opt = topt.Adam(learning_rate=lr, parameters=net.parameters())
    return Model(net).prepare(opt, tnn.CrossEntropyLoss(),
                              tmetric.Accuracy())


def test_early_stopping_stops_training():
    m = _prepared()
    rec = _recorder(tcb.Callback)
    # "max" on a falling loss: no epoch after the first is better
    stop = tcb.EarlyStopping(monitor="loss", mode="max", patience=1)
    m.fit(Blobs(), batch_size=4, epochs=6, verbose=0,
          callbacks=[stop, rec])
    assert m.stop_training
    assert [e[1] for e in rec.events if e[0] == "epoch_begin"] == [0, 1]


def test_model_checkpoint_writes_each_epoch_and_final(tmp_path):
    m = _prepared()
    m.fit(Blobs(), batch_size=8, epochs=2, verbose=0,
          save_dir=str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                     "final.pdopt", "final.pdparams"]
    other = _prepared()
    other.load(str(tmp_path / "final"))
    for a, b in zip(m.parameters(), other.parameters()):
        assert torch.equal(a, b)


def test_lr_scheduler_callback_steps_by_step_or_epoch():
    for by_step, want in ((True, 8), (False, 2)):
        net = _small_model()
        sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
        m = Model(net).prepare(topt.Adam(learning_rate=sched,
                                         parameters=net.parameters()),
                               tnn.CrossEntropyLoss())
        cb = tcb.LRScheduler(by_step=by_step, by_epoch=not by_step)
        m.fit(Blobs(), batch_size=4, epochs=2, verbose=0, callbacks=[cb])
        assert sched.last_epoch == want


def test_reduce_lr_on_plateau_cuts_the_rate():
    m = _prepared(lr=0.05)
    cb = tcb.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=0,
                               mode="max", min_delta=0.0)
    m.fit(Blobs(), batch_size=4, epochs=3, verbose=0, callbacks=[cb])
    assert m._optimizer.get_lr() < 0.05


def test_progbar_prints(capsys):
    m = _prepared()
    m.fit(Blobs(), batch_size=8, epochs=1, verbose=2, log_freq=1)
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "step 2/2" in out and "loss:" in out


def test_summary_counts_parameters(capsys):
    m = _prepared()
    m.network[0].bias.requires_grad_(False)
    assert m.summary() == {"total_params": 15, "trainable_params": 12}
    assert m.summary(input_size=(2, 4)) == {"total_params": 15,
                                            "trainable_params": 12}
    assert "0 (Linear)" in capsys.readouterr().out


def test_refusals():
    m = Model(_small_model())
    with pytest.raises(NotImplementedError, match="amp_configs"):
        m.prepare(amp_configs={"level": "O1"})
    # comm_traffic is ported (test_torch_hapi_dist.py): unprepared, or on
    # a single rank, it raises the reference's RuntimeError
    with pytest.raises(RuntimeError, match="prepare"):
        m.comm_traffic()
    with pytest.raises(RuntimeError, match="multi-device"):
        _prepared().comm_traffic()


def test_fit_loader_follows_the_network_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _prepared()
    m.fit(Blobs(), batch_size=8, epochs=1, verbose=0, num_workers=0)
    assert m._device.type == "cpu"


# -- ParamAttr: rate factors and regularizers -----------------------------

def _attr_pair(mod, initializer, reg):
    """A Linear(3, 2) of package ``mod`` with a weight at learning rate
    0.5 under ``reg`` and a frozen bias."""
    w = mod.nn.ParamAttr(initializer=initializer(0.3), learning_rate=0.5,
                         regularizer=reg)
    b = mod.nn.ParamAttr(initializer=initializer(0.1), trainable=False)
    return w, b


@pytest.mark.parametrize("reg", ["l1", "l2"])
@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_param_attr_rate_and_regularizer_match_functional_update(opt, reg):
    import paddle_tpu_torch as tpkg
    from paddle_tpu.nn import initializer as RI
    from paddle_tpu_torch.nn import initializer as TI

    rng = np.random.default_rng(4)
    grads = [rng.standard_normal((3, 2)).astype(np.float32),
             rng.standard_normal(2).astype(np.float32)]
    kw = dict(learning_rate=0.01, weight_decay=0.02 if opt == "AdamW"
              else None)
    with no_mesh():
        rreg = (paddle.regularizer.L1Decay if reg == "l1"
                else paddle.regularizer.L2Decay)(0.05)
        wa, ba = _attr_pair(paddle, RI.Constant, rreg)
        ref_lin = rnn.Linear(3, 2, weight_attr=wa, bias_attr=ba)
        ropt = getattr(paddle.optimizer, opt)(
            parameters=ref_lin.parameters(), **kw)
        params = [raw(p) for p in ropt._parameter_list]
        states = ropt.functional_states()
        for _ in range(2):
            params, states = ropt.functional_update(
                params, [jnp.asarray(g) for g in grads], states,
                jnp.asarray(0.01, jnp.float32))
        want = [np.asarray(p) for p in params]
    treg = (topt.L1Decay if reg == "l1" else topt.L2Decay)(0.05)
    wa, ba = _attr_pair(tpkg, TI.Constant, treg)
    lin = tnn.Linear(3, 2, weight_attr=wa, bias_attr=ba, device="cpu")
    assert not lin.bias.requires_grad
    assert lin.weight.optimize_attr == {"learning_rate": 0.5}
    o = getattr(topt, opt)(parameters=lin.parameters(), **kw)
    for _ in range(2):
        lin.weight.grad = torch.from_numpy(grads[0])
        o.step()
    np.testing.assert_allclose(lin.weight.detach().numpy(), want[0],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lin.bias.detach().numpy(), want[1], rtol=0)
    assert np.allclose(want[1], 0.1)  # the frozen bias did not move
