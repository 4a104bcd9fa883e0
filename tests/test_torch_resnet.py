"""ResNet of the PyTorch port (``paddle_tpu_torch/vision/models/resnet.py``)
against the reference's ``paddle_tpu.vision.models`` on the CPU, on
bridged weights: ResNet-18 and ResNet-50 at ``num_classes=10``.

- state names (``layer2.0.downsample.1._mean``, ...), shapes and the
  parameter order (the optimizer's state order);
- eval logits (batch 2, 32 x 32), and train-mode logits with the BN
  statistics they leave (batch 4, 64 x 64);
- 3 ``Momentum`` steps (lr 0.1, momentum 0.9, weight decay 1e-4, with and
  without Nesterov) through the reference's compiled ``TrainStep`` and
  the port's, batch 2 at 32 x 32, with the batch norms in inference mode
  (frozen statistics, as a fine-tuning run freezes them): losses and
  every parameter; then 3 steps of ResNet-18 in training mode (batch 4,
  64 x 64, lr 1e-3): losses, parameters and ``_mean`` / ``_variance``;
- the AMP cast log of ResNet-18 at O1 and O2 (train and eval, and O2
  after ``decorate``): the sets of ``(op name, dtypes after the cast)``
  both gateways see are equal;
- ``paddle.Model`` end to end on ResNet-18 over ``FakeData`` with the
  ImageNet training transforms (``RandomResizedCrop``,
  ``RandomHorizontalFlip``, ``ToTensor``, ``Normalize``) under one
  ``random`` / numpy seed: per-step losses, ``evaluate`` with top-1 /
  top-5 ``Accuracy``, ``predict``, ``summary``'s counts, and
  ``.pdparams`` / ``.pdopt`` loading both ways (running statistics
  included).

Tolerance: logits, losses and 3-step trajectories within 1e-4 of the
largest reference magnitude (``RTOL``). Why these sizes: a ReLU
network's gradient jumps where a pre-activation crosses zero, and two
f32 implementations round a pre-activation within ~1e-7 of zero to
either side. In training mode the batch norm's backward spreads one such
flip over its whole channel: at ResNet-50's random init one flipped
element of ~1.6 M moved a block's gradients by 0.6-21 % (measured, 4 x 64
x 64; the reference's own compiled and eager gradients differ as much,
and the port's f32 and f64 ones). With inference-mode batch norms, or at
ResNet-18's size, no pre-activation sits that close to zero and both
sides agree to ~1e-6. At batch 2 and 32 x 32 the last stage is 1 x 1, so
a training-mode batch norm there normalises 2 values per channel and
its forward already amplifies rounding (1.5e-2 of the largest ResNet-18
logit, measured): the training-mode checks run at batch 4, 64 x 64.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu import amp as ref_amp
from paddle_tpu import metric as rmetric
from paddle_tpu import nn as rnn
from paddle_tpu.framework import op as ref_op
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.vision import datasets as rds
from paddle_tpu.vision import models as rmodels
from paddle_tpu.vision import transforms as rT
from paddle_tpu_torch import Model, amp
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import load_numpy_state
from paddle_tpu_torch.framework import op as top
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision import transforms as tT

from torch_port_utils import numpy_state

RTOL = 1e-4
CLASSES = 10
DEPTHS = ("resnet18", "resnet50")


def close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU convolutions: the suite runs
    6 test processes at once, and 6 pools of spinning threads slowed this
    file's parallel run 6-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REFERENCE = {}  # (name, seed) -> (reference model, its initial state)


def models(name, seed=7, fresh=False):
    """The reference model (train mode) and the port's on the CPU with its
    weights. The reference model of each (name, seed) is built once (its
    eager initialisers cost seconds) and reset to its initial state on
    each call; ``fresh`` builds a new one (for a test that casts it)."""
    key = (name, seed)
    if fresh or key not in _REFERENCE:
        paddle.seed(seed)
        ref = getattr(rmodels, name)(num_classes=CLASSES)
        state = {k: v.copy() for k, v in numpy_state(ref).items()}
        if fresh:
            ref.train()
            port = getattr(tmodels, name)(num_classes=CLASSES, device="cpu")
            return ref, load_numpy_state(port, state)
        _REFERENCE[key] = (ref, state)
    ref, state = _REFERENCE[key]
    ref.set_state_dict(state)
    ref.train()
    port = getattr(tmodels, name)(num_classes=CLASSES, device="cpu")
    load_numpy_state(port, state)
    return ref, port


def batches(n=3, b=2, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 3, hw, hw)).astype(np.float32),
             rng.integers(0, CLASSES, (b,))) for _ in range(n)]


def port_state(m):
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("name", DEPTHS)
def test_state_names_and_order_match_reference(name):
    ref, port = models(name)
    rstate = numpy_state(ref)
    pstate = port.state_dict()
    assert set(pstate) == set(rstate)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    for k, v in rstate.items():
        assert tuple(pstate[k].shape) == v.shape, k
    assert "layer2.0.downsample.1._mean" in pstate
    assert "layer4.1.bn2._variance" in pstate


@pytest.mark.parametrize("name", DEPTHS)
def test_logits_match_reference(name):
    """Eval logits on the bridged running statistics, then train-mode
    logits (batch statistics) and the statistics they leave."""
    ref, port = models(name)
    x, _ = batches(1)[0]
    ref.eval()
    port.eval()
    close(port(torch.from_numpy(x)).detach().numpy(),
          raw(ref(jnp.asarray(x))), what="eval")
    ref.train()
    port.train()
    x, _ = batches(1, b=4, hw=64)[0]
    close(port(torch.from_numpy(x)).detach().numpy(),
          raw(ref(jnp.asarray(x))), what="train")
    rstate = numpy_state(ref)
    for k, v in port_state(port).items():
        if k.endswith(("_mean", "_variance")):
            close(v, rstate[k], what=k)


def _momentum(opt_mod, params, nesterov, lr=0.1):
    return opt_mod.Momentum(learning_rate=lr, momentum=0.9,
                            parameters=params, use_nesterov=nesterov,
                            weight_decay=1e-4)


def _trajectory(name, mode, nesterov, lr, b, hw):
    """Both packages' losses over 3 ``TrainStep`` steps from the same
    weights, and each one's state after them."""
    ref, port = models(name)
    getattr(ref, mode)()
    getattr(port, mode)()
    start = port_state(port)
    ref_step = RefTrainStep(
        ref, lambda m, x, y: RF.cross_entropy(m(x), y),
        _momentum(paddle.optimizer, ref.parameters(), nesterov, lr))
    port_step = TrainStep(port, lambda m, x, y: TF.cross_entropy(m(x), y),
                          _momentum(topt, port.parameters(), nesterov, lr))
    losses = []
    for x, y in batches(b=b, hw=hw):
        losses.append((float(port_step(torch.from_numpy(x),
                                       torch.from_numpy(y))),
                       float(ref_step(Tensor(jnp.asarray(x)),
                                      Tensor(jnp.asarray(y))))))
    return losses, start, port_state(port), numpy_state(ref)


def _check_trajectory(losses, start, got, want):
    for i, (g, w) in enumerate(losses):
        close(g, w, what=f"loss {i}")
    for k, v in want.items():
        close(got[k], v, what=k)
    assert not np.allclose(got["fc.weight"], start["fc.weight"])
    assert not np.allclose(got["conv1.weight"], start["conv1.weight"])


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("name", DEPTHS)
def test_momentum_trajectory_matches_reference(name, nesterov):
    """Inference-mode batch norms: every parameter (the BN affine ones
    included) trains, the running statistics stay."""
    losses, start, got, want = _trajectory(name, "eval", nesterov, 0.1, 2,
                                           32)
    _check_trajectory(losses, start, got, want)
    np.testing.assert_array_equal(got["bn1._mean"], start["bn1._mean"])


def test_training_mode_trajectory_matches_reference():
    """ResNet-18 with batch statistics: losses, parameters and the running
    statistics after 3 steps."""
    losses, start, got, want = _trajectory("resnet18", "train", False, 1e-3,
                                           4, 64)
    _check_trajectory(losses, start, got, want)
    assert not np.allclose(got["bn1._mean"], 0.0)


# ------------------------------------------------------------------- AMP --


@pytest.fixture
def cast_logs(monkeypatch):
    """Spies on both AMP gateways: ``(reference log, port log)`` of
    ``(op name, dtypes after the cast)`` taken while AMP is on."""
    ref_log, port_log = [], []
    ref_cast, port_cast = ref_op._amp_cast, top._amp_cast

    def ref_spy(name, vals):
        out = ref_cast(name, vals)
        if ref_op.amp_state.enable:
            ref_log.append((name, tuple(str(v.dtype) for v in out)))
        return out

    def port_spy(name, *vals):
        out = port_cast(name, *vals)
        if top.amp_state.enable:
            port_log.append((name, tuple(str(v.dtype)[6:] for v in out
                                         if v is not None)))
        return out

    monkeypatch.setattr(ref_op, "_amp_cast", ref_spy)
    monkeypatch.setattr(top, "_amp_cast", port_spy)
    return ref_log, port_log


@pytest.mark.parametrize("case", ["O1-train", "O1-eval", "O2-train",
                                  "O2-eval", "O2-decorate"])
def test_cast_log_matches_reference(case, cast_logs):
    level, mode = case.split("-")
    ref_log, port_log = cast_logs
    ref, port = models("resnet18", fresh=mode == "decorate")
    if mode == "decorate":
        ref_amp.decorate(ref, level="O2")
        amp.decorate(port, level="O2")
        mode = "train"
    getattr(ref, mode)()
    getattr(port, mode)()
    x, y = batches(1)[0]
    with ref_amp.auto_cast(level=level):
        RF.cross_entropy(ref(Tensor(jnp.asarray(x))), Tensor(jnp.asarray(y)))
    with amp.auto_cast(level=level):
        TF.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
    assert ref_log and set(port_log) == set(ref_log)
    names = dict(port_log)
    assert names["conv2d"] == ("bfloat16",) * 2
    bn = "batch_norm_train" if mode == "train" else "batch_norm_infer"
    assert set(names[bn]) == {"float32"}
    # the same number of casts of each op: one per conv / norm / add ...
    count = lambda log, op: sum(n == op for n, _ in log)  # noqa: E731
    for op in ("conv2d", bn, "add", "relu"):
        assert count(port_log, op) == count(ref_log, op), op
    assert count(port_log, "conv2d") == 20


# -------------------------------------------------------- paddle.Model --

TRAIN_N, EVAL_N, BATCH = 8, 4, 4


def _train_tf(T):
    return T.Compose([T.RandomResizedCrop(64), T.RandomHorizontalFlip(),
                      T.ToTensor(),
                      T.Normalize([0.485, 0.456, 0.406],
                                  [0.229, 0.224, 0.225])])


def _eval_tf(T):
    return T.Compose([T.Resize(72), T.CenterCrop(64), T.ToTensor(),
                      T.Normalize([0.485, 0.456, 0.406],
                                  [0.229, 0.224, 0.225])])


def _data(ds, T):
    return (ds.FakeData(TRAIN_N, (72, 80, 3), CLASSES, _train_tf(T)),
            ds.FakeData(EVAL_N, (72, 76, 3), CLASSES, _eval_tf(T)))


class _Losses:
    def __init__(self, base):
        class Rec(base):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])

        self.cb = Rec()


@pytest.fixture(scope="module")
def hapi_runs(tmp_path_factory):
    """Both packages' ``Model`` on ResNet-18 from the same weights: ``fit``
    (2 steps of 4 images cropped to 64 x 64, training-mode batch norms, so
    at the training-mode trajectory's size and rate), ``evaluate``,
    ``predict`` and ``save``."""
    from paddle_tpu.hapi import callbacks as rcb
    from paddle_tpu_torch.hapi import callbacks as tcb

    tmp = tmp_path_factory.mktemp("resnet_hapi")
    out = {"tmp": tmp}
    for side, pkg, mds, ds, T, metric, cb in (
            ("ref", paddle.optimizer, rmodels, rds, rT, rmetric, rcb),
            ("port", topt, tmodels, tds, tT, tmetric, tcb)):
        ref, port = models("resnet18", seed=3)
        net = ref if side == "ref" else port
        sched = pkg.lr.PiecewiseDecay([1], [1e-3, 1e-4])
        opt = pkg.Momentum(sched, 0.9, parameters=net.parameters(),
                           weight_decay=1e-4)
        model = (paddle.Model if side == "ref" else Model)(net).prepare(
            opt, (rnn if side == "ref" else tnn).CrossEntropyLoss(),
            metric.Accuracy(topk=(1, 5)))
        train, evals = _data(ds, T)
        rec = _Losses(cb.Callback).cb
        random.seed(5)
        np.random.seed(5)
        model.fit(train, batch_size=BATCH, epochs=1, verbose=0,
                  callbacks=[rec, cb.LRScheduler(by_step=True)])
        out[side] = dict(
            losses=rec.losses,
            eval=model.evaluate(evals, batch_size=BATCH, verbose=0),
            pred=model.predict(evals, batch_size=BATCH, stack_outputs=True)[0],
            summary=model.summary(),
            state=numpy_state(net) if side == "ref" else port_state(net),
            lr=opt.get_lr())
        model.save(str(tmp / side))
    return out


def test_fit_evaluate_predict_match_reference(hapi_runs):
    ref, port = hapi_runs["ref"], hapi_runs["port"]
    assert len(port["losses"]) == len(ref["losses"]) == TRAIN_N // BATCH
    close(port["losses"], ref["losses"], what="fit losses")
    assert port["lr"] == ref["lr"] == 1e-4
    assert set(port["eval"]) == set(ref["eval"]) == {"loss", "acc_top1",
                                                     "acc_top5"}
    close(port["eval"]["loss"], ref["eval"]["loss"], what="eval loss")
    for k in ("acc_top1", "acc_top5"):
        assert port["eval"][k] == ref["eval"][k]
        assert 0.0 <= port["eval"][k] <= 1.0
    assert port["pred"].shape == (EVAL_N, CLASSES)
    close(port["pred"], ref["pred"], what="predict")
    for k, v in ref["state"].items():
        close(port["state"][k], v, what=k)
    assert port["summary"] == ref["summary"] == {
        "total_params": 11_181_642, "trainable_params": 11_181_642}


def test_checkpoints_interchange_both_ways(hapi_runs):
    """Each package's ``.pdparams`` / ``.pdopt`` loads into the other:
    parameters, running statistics and velocities arrive bit for bit."""
    tmp = hapi_runs["tmp"]
    ref, port = models("resnet18", seed=11)
    ref_opt = paddle.optimizer.Momentum(0.1, 0.9,
                                        parameters=ref.parameters())
    paddle.Model(ref).prepare(ref_opt, rnn.CrossEntropyLoss()).load(
        str(tmp / "port"))
    port_opt = topt.Momentum(0.1, 0.9, parameters=port.parameters())
    Model(port).prepare(port_opt, tnn.CrossEntropyLoss()).load(
        str(tmp / "ref"))
    for k, v in hapi_runs["port"]["state"].items():
        np.testing.assert_array_equal(numpy_state(ref)[k], v, err_msg=k)
    for k, v in hapi_runs["ref"]["state"].items():
        np.testing.assert_array_equal(port_state(port)[k], v, err_msg=k)
    rv = {k: np.asarray(raw(v)) for k, v in ref_opt.state_dict().items()
          if k != "LR_Scheduler"}
    pv = {k: v.numpy() for k, v in port_opt.state_dict().items()}
    assert set(rv) == set(pv) and len(pv) == 62
    for k in rv:
        assert k.endswith(".velocity")
    # the reference network now holds the port's trained state and the
    # port's network the reference's: each one's eval logits equal the
    # other package's on the same state
    x = batches(1)[0][0]
    ref_b, port_b = models("resnet18", seed=12)
    paddle.Model(ref_b).load(str(tmp / "ref"))
    Model(port_b).load(str(tmp / "port"))
    for r, p in ((ref_b, port), (ref, port_b)):
        r.eval()
        p.eval()
        close(p(torch.from_numpy(x)).detach().numpy(),
              raw(r(jnp.asarray(x))), what="eval logits after loading")


def test_pretrained_raises():
    with pytest.raises(NotImplementedError, match="pretrained"):
        tmodels.resnet18(pretrained=True, device="cpu")


@pytest.mark.parametrize("ctor", ["resnet34", "resnext50_32x4d"])
def test_other_constructors_match_reference_shapes(ctor):
    paddle.seed(0)
    want = {k: tuple(v.shape) for k, v in
            getattr(rmodels, ctor)(num_classes=CLASSES).state_dict().items()}
    port = getattr(tmodels, ctor)(num_classes=CLASSES, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
