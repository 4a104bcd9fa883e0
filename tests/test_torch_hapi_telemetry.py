"""The port's observability callbacks (``paddle_tpu_torch/hapi/callbacks.py``:
``VisualDL``, ``TelemetryLogger``, ``WandbCallback``, and the
``TelemetryLogger`` that ``config_callbacks`` appends) and ``Model.fit``'s
step-FLOPs probe, against the reference's: the telemetry cases of
``tests/test_observability.py`` case for case, then both packages' ``fit``
on one tiny classifier with ``PADDLE_TPU_TELEMETRY_DIR`` set, whose
``train_step`` events must carry the same keys. The port's
``TrainStep.cost_analysis`` raises (ROADMAP.md §A.3), so its probe gives
None and the logger exports tokens/s without FLOP/s or MFU, where the
reference's reads XLA's count.
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as rpaddle
from paddle_tpu import io as rio
from paddle_tpu import nn as rnn
from paddle_tpu import observability as robs
from paddle_tpu import optimizer as ropt
from paddle_tpu.hapi import callbacks as rcb
from paddle_tpu_torch import Model
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.hapi import callbacks as C

from torch_port_utils import no_mesh

N, BATCH, EPOCHS = 16, 4, 2


@pytest.fixture
def tdir(tmp_path, monkeypatch):
    """Telemetry on into a fresh directory, both registries reset."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    obs.reset()
    robs.reset()
    yield tmp_path
    obs.reset()
    robs.reset()


def _events(d, kind=None):
    p = d / "events_rank0.jsonl"
    if not p.exists():
        return []
    evs = [json.loads(line) for line in p.read_text().splitlines() if line]
    return [e for e in evs if kind is None or e["kind"] == kind]


def _drive_logger(cb_mod, logs):
    tl = cb_mod.TelemetryLogger()
    tl.set_params({"epochs": 1, "steps": 1})
    tl.on_train_begin()
    tl.on_train_batch_begin(0)
    time.sleep(0.005)
    tl.on_train_batch_end(0, logs)
    tl.on_train_end()


def test_telemetry_logger_callback(tdir, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e9")
    logs = {"loss": 0.5, "batch_size": 16, "step_flops": 2.0e6}
    _drive_logger(C, logs)
    reg = obs.registry()
    assert reg.get("train_tokens_per_second").value() > 0
    assert reg.get("train_flops_per_second").value() > 0
    assert reg.get("train_mfu").value() > 0
    evs = _events(tdir)
    assert [e["phase"] for e in evs if e["kind"] == "train_run"] == [
        "begin", "end"]
    step = next(e for e in evs if e["kind"] == "train_step")
    assert step["loss"] == 0.5
    assert step["tokens_per_second"] > 0 and step["mfu"] > 0
    assert (tdir / "metrics_rank0.prom").exists()  # on_train_end flushes
    # the reference's logger writes the same events with the same keys
    (tdir / "events_rank0.jsonl").unlink()
    _drive_logger(rcb, logs)
    want = _events(tdir)
    assert [sorted(e) for e in want] == [sorted(e) for e in evs]
    assert [e["kind"] for e in want] == [e["kind"] for e in evs]


def test_telemetry_logger_is_free_when_off(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_DIR", raising=False)
    tl = C.TelemetryLogger()
    tl.on_train_batch_begin(0)
    assert tl._t0 is None
    tl.on_train_batch_end(0, {"loss": 1.0, "batch_size": 4})
    assert not list(tmp_path.iterdir())


def test_config_callbacks_auto_appends_telemetry_logger():
    lst = C.config_callbacks(verbose=0)
    assert sum(isinstance(c, C.TelemetryLogger) for c in lst.callbacks) == 1
    mine = C.TelemetryLogger()
    lst2 = C.config_callbacks(callbacks=[mine], verbose=0)
    assert [c for c in lst2.callbacks
            if isinstance(c, C.TelemetryLogger)] == [mine]
    # the same callback kinds, in the same order, as the reference's
    for kw in (dict(verbose=0), dict(verbose=2, save_dir="unused")):
        assert [type(c).__name__ for c in
                C.config_callbacks(**kw).callbacks] == [
            type(c).__name__ for c in rcb.config_callbacks(**kw).callbacks]


def test_wandb_callback_raises_the_reference_s_import_error():
    with pytest.raises(ImportError) as got:
        C.WandbCallback(project="p")
    with pytest.raises(ImportError) as want:
        rcb.WandbCallback(project="p")
    assert str(got.value) == str(want.value)
    assert "pip install wandb" in str(got.value)


def _data(rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    x = rng.standard_normal((N, 4)).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.int64)


def _port_fit(callbacks, state=None):
    x, y = _data()

    class Blobs(tio.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return N

    torch.manual_seed(0)
    net = torch.nn.Sequential(tnn.Linear(4, 3, device="cpu"))
    if state is not None:  # the reference's initial weights
        with torch.no_grad():
            for k, v in state.items():
                getattr(net[0], k).copy_(torch.from_numpy(v))
    m = Model(net).prepare(topt.SGD(learning_rate=0.1,
                                    parameters=net.parameters()),
                           tnn.CrossEntropyLoss())
    m.fit(Blobs(), batch_size=BATCH, epochs=EPOCHS, verbose=0,
          shuffle=False, callbacks=callbacks)
    return m


def _ref_fit(callbacks, init):
    """The reference's fit; ``init`` receives its initial weights."""
    from paddle_tpu.framework.op import raw

    x, y = _data()

    class Blobs(rio.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return N

    with no_mesh():
        rpaddle.seed(0)
        net = rnn.Linear(4, 3)
        init.update({k: np.array(raw(v))
                     for k, v in net.state_dict().items()})
        m = rpaddle.Model(net)
        m.prepare(ropt.SGD(learning_rate=0.1, parameters=net.parameters()),
                  rnn.CrossEntropyLoss())
        m.fit(Blobs(), batch_size=BATCH, epochs=EPOCHS, verbose=0,
              shuffle=False, callbacks=callbacks)
    return m


def _rows(path):
    return [line.split("\t") for line in path.read_text().splitlines()]


def test_fit_telemetry_and_visualdl_against_reference(tdir):
    """Both packages' ``fit`` with telemetry on: one ``train_step`` event
    a batch with tokens/s, the same event keys (no PEAK set: no MFU on
    either side), one VisualDL row a batch and numeric log. The port's
    FLOPs probe ran once and found no count."""
    steps = EPOCHS * N // BATCH
    init = {}
    r = _ref_fit([rcb.VisualDL(str(tdir / "vdl_ref"))], init)
    want = _events(tdir, "train_step")
    assert r._step_flops  # the reference reads XLA's count
    ref_rows = _rows(tdir / "vdl_ref" / "scalars.tsv")
    (tdir / "events_rank0.jsonl").unlink()

    m = _port_fit([C.VisualDL(str(tdir / "vdl_port"))], init)
    got = _events(tdir, "train_step")
    assert len(got) == steps
    assert [e["step"] for e in got] == list(range(N // BATCH)) * EPOCHS
    assert all(e["tokens_per_second"] > 0 for e in got)
    assert m._step_flops is False
    assert obs.registry().get("train_flops_per_second") is None
    port_rows = _rows(tdir / "vdl_port" / "scalars.tsv")
    assert [(int(s), k) for s, k, _ in port_rows] == [
        (s, k) for s in range(steps) for k in ("loss", "batch_size")]
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    assert [(s, k) for s, k, _ in ref_rows if k != "step_flops"] == [
        (s, k) for s, k, _ in port_rows]
    # the same losses through both from the same weights (f32 SGD on a
    # 4 x 3 linear layer)
    np.testing.assert_allclose(
        [float(v) for _, k, v in port_rows if k == "loss"],
        [float(v) for _, k, v in ref_rows if k == "loss"], rtol=1e-5)


def test_probe_skipped_when_telemetry_is_off(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_DIR", raising=False)
    m = _port_fit([])
    assert m._step_flops is None  # never probed


def test_cost_analysis_still_raises_naming_a3():
    from paddle_tpu_torch.jit import TrainStep

    step = TrainStep(torch.nn.Linear(2, 2), lambda o, y: o.sum(),
                     topt.SGD(learning_rate=0.1, parameters=[]))
    with pytest.raises(NotImplementedError, match="A.3"):
        step.cost_analysis(torch.ones(1, 2), torch.ones(1))
