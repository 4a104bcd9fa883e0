"""The deployment path of the PyTorch port (``paddle_tpu_torch/jit``,
``inference``, ``static``, ``ops/library.py``) against ``paddle_tpu`` on
the CPU, on the same weights (bridged with ``load_numpy_state``) and the
same numpy inputs from a seed:

* the reference's seven ``tests/test_inference.py`` cases on its
  ``SmallNet``: round trip, batch-polymorphic, handles, inputs kept on the
  device, positional run, ``save_inference_model``, the
  ``TranslatedLayer``'s state; each output against the reference's own
  ``jit.save`` -> ``jit.load`` (f32, rtol 1e-5: the same products in other
  summation orders);
* a 2-layer GPT (hidden 64, 4 heads, vocab 128) and a 2-layer ERNIE under
  a padding mask: one port artifact with ``None`` dims, served through
  ``jit.load`` and ``create_predictor`` at two shapes, against the
  reference's artifacts (f32, rtol 1e-5, on both CPU routes of the
  recorded attention op). The reference's ``jit.save`` refuses ``None``
  dims on these models (its reshape asks a symbolic dim for a constant,
  ROADMAP.md §C.42), so it saves one artifact per shape;
* the exported graph: one ``paddle_tpu::attention`` node per layer, no
  einsum or softmax of the plain route; the op's CUDA body launches K1;
* the ``.pdiparams`` of the small GPT: the reference's keys and arrays;
* ``to_static``: outputs, ``program_cache_size`` and one training step's
  gradients against the reference's ``to_static`` (its gradient read off
  an SGD step at learning rate 1 through its ``TrainStep``), the kill
  switch, the host-sync fall-back;
* ``PredictorPool``, ``Config``'s knobs and path forms, bf16 weights.

Each artifact is built once per module by a fixture.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as rpaddle
from paddle_tpu import nn as rnn
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import InputSpec as RInputSpec
from paddle_tpu.jit import TrainStep as RefTrainStep

import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, nn
from paddle_tpu_torch.framework.io_state import load_numpy_state
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import library

from torch_port_utils import (encoder_batch, jax_tiny_encoder, jax_tiny_gpt,
                              numpy_state, torch_tiny_encoder,
                              torch_tiny_gpt)

RTOL = ATOL = 1e-5
GPT_KW = dict(vocab_size=128, hidden_size=64, num_attention_heads=4)
GPT_SHAPES = ((2, 16), (1, 40))
ERNIE_SHAPES = ((3, 12), (2, 20))
ERNIE_INPUTS = ("input_ids", "token_type_ids", "attention_mask")
# the training step's gradients, max |err| / max |grad| over all
# parameters: f32 sums in other orders, and the reference's gradient read
# off p - (p - g), within one ulp of |p| <= 1
GRAD_TOL = 1e-5


def _np(t):
    return np.asarray(raw(t))


class RefSmallNet(rnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = rnn.Linear(16, 32)
        self.fc2 = rnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(rnn.functional.relu(self.fc1(x)))


class SmallNet(nn.Layer):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(16, 32, device="cpu", dtype=dtype)
        self.fc2 = nn.Linear(32, 4, device="cpu", dtype=dtype)

    def forward(self, x):
        return self.fc2(nn.functional.relu(self.fc1(x)))


@pytest.fixture(scope="module")
def small():
    """(reference SmallNet in eval mode, port SmallNet on its weights)."""
    rpaddle.seed(0)
    ref = RefSmallNet()
    ref.eval()
    net = load_numpy_state(SmallNet(), numpy_state(ref))
    net.eval()
    return ref, net


def _both_saved(small, tmp_path, spec, name="m"):
    """The reference's and the port's artifacts of SmallNet for ``spec``
    (``(shape, name)``); returns their prefixes."""
    ref, net = small
    shape, in_name = spec
    rp, tp = str(tmp_path / f"ref_{name}"), str(tmp_path / f"port_{name}")
    rpaddle.jit.save(ref, rp, input_spec=[RInputSpec(shape, "float32",
                                                      in_name)])
    paddle.jit.save(net, tp, input_spec=[InputSpec(shape, "float32",
                                                   in_name)])
    return rp, tp


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# -------------------------------------- the reference's test_inference.py


def test_jit_save_load_roundtrip(small, tmp_path):
    rp, tp = _both_saved(small, tmp_path, ([3, 16], "x"))
    x = _x((3, 16), 0)
    loaded = paddle.jit.load(tp, device="cpu")
    want = _np(rpaddle.jit.load(rp)(rpaddle.to_tensor(x)))
    np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    assert loaded.input_names == ["x"]


def test_jit_save_batch_polymorphic(small, tmp_path):
    rp, tp = _both_saved(small, tmp_path, ([None, 16], "x"))
    ref_loaded = rpaddle.jit.load(rp)
    loaded = paddle.jit.load(tp, device="cpu")
    for bs in (1, 5, 9):
        x = np.ones((bs, 16), "float32")
        out = loaded(torch.from_numpy(x))
        assert tuple(out.shape) == (bs, 4)
        np.testing.assert_allclose(
            out.numpy(), _np(ref_loaded(rpaddle.to_tensor(x))), rtol=RTOL,
            atol=ATOL)


def test_predictor_handles(small, tmp_path):
    from paddle_tpu import inference as rinference

    rp, tp = _both_saved(small, tmp_path, ([2, 16], "input"))
    x = _x((2, 16), 1)
    outs = []
    for mod, prefix, cpu in ((rinference, rp, False), (inference, tp, True)):
        config = mod.Config(prefix)
        config.enable_memory_optim()
        if cpu:
            config.disable_gpu()
        predictor = mod.create_predictor(config)
        assert predictor.get_input_names() == ["input"]
        predictor.get_input_handle("input").copy_from_cpu(x)
        predictor.run()
        names = predictor.get_output_names()
        assert names == ["fetch_0"]
        outs.append(predictor.get_output_handle(names[0]).copy_to_cpu())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def test_predictor_inputs_stay_device_resident(small, tmp_path):
    # run() uploads an input again only when copy_from_cpu bumped its
    # version; unchanged handles reuse the tensor on the device, and the
    # output handles hold device tensors until copy_to_cpu
    rp, tp = _both_saved(small, tmp_path, ([2, 16], "input"))
    config = inference.Config(tp)
    config.disable_gpu()
    predictor = inference.create_predictor(config)
    h = predictor.get_input_handle("input")
    x = _x((2, 16), 2)
    h.copy_from_cpu(x)
    predictor.run()
    dev1 = predictor._dev_inputs["input"][1]
    assert isinstance(dev1, torch.Tensor) and dev1.device.type == "cpu"
    predictor.run()  # no copy_from_cpu between runs
    assert predictor._dev_inputs["input"][1] is dev1
    h.copy_from_cpu(x + 1.0)
    predictor.run()
    assert predictor._dev_inputs["input"][1] is not dev1
    out_h = predictor.get_output_handle(predictor.get_output_names()[0])
    assert isinstance(out_h._value, torch.Tensor)
    want = _np(rpaddle.jit.load(rp)(rpaddle.to_tensor(x + 1.0)))
    np.testing.assert_allclose(out_h.copy_to_cpu(), want, rtol=RTOL,
                               atol=ATOL)


def test_predictor_positional_run(small, tmp_path):
    from paddle_tpu import inference as rinference

    rp, tp = _both_saved(small, tmp_path, ([None, 16], None))
    x = _x((4, 16), 3)
    config = inference.Config(tp + ".pdmodel")
    config.disable_gpu()
    outs = inference.create_predictor(config).run([x])
    assert len(outs) == 1 and outs[0].shape == (4, 4)
    want = rinference.create_predictor(
        rinference.Config(rp + ".pdmodel")).run([x])
    np.testing.assert_allclose(outs[0], want[0], rtol=RTOL, atol=ATOL)


def test_save_inference_model_wiring(small, tmp_path):
    ref, net = small
    rp, tp = str(tmp_path / "ref_static"), str(tmp_path / "port_static")
    rpaddle.static.save_inference_model(
        rp, [RInputSpec([2, 16], "float32", "x")], None, model=ref)
    paddle.static.save_inference_model(
        tp, [paddle.static.InputSpec([2, 16], "float32", "x")], None,
        model=net)
    layer, feed_names, fetch = paddle.static.load_inference_model(
        tp, device="cpu")
    rlayer, rfeed, _ = rpaddle.static.load_inference_model(rp)
    assert feed_names == rfeed == ["x"] and fetch is None
    x = np.ones((2, 16), "float32")
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                               _np(rlayer(rpaddle.to_tensor(x))),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="model="):
        paddle.static.save_inference_model(tp, [], None)


def test_translated_layer_state_dict(small, tmp_path):
    rp, tp = _both_saved(small, tmp_path, ([1, 16], None))
    loaded = paddle.jit.load(tp, device="cpu")
    sd = {k: v.clone() for k, v in loaded.state_dict().items()}
    rsd = rpaddle.jit.load(rp).state_dict()
    assert len(sd) == 4  # fc1/fc2 weight+bias as frozen buffers
    assert sorted(sd) == sorted(rsd) == ["fc1__bias", "fc1__weight",
                                         "fc2__bias", "fc2__weight"]
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), _np(rsd[k]))
    assert not list(loaded.parameters())
    # the buffers are what the program reads: a state loaded back moves
    # the output
    x = torch.ones((1, 16))
    base = loaded(x)
    loaded.load_state_dict({k: v * 2 for k, v in sd.items()})
    assert not torch.allclose(loaded(x), base)
    loaded.load_state_dict(sd)
    torch.testing.assert_close(loaded(x), base, rtol=0, atol=0)


# ------------------------------------------------ GPT and ERNIE artifacts


def _gpt_inputs(shape):
    return [np.random.default_rng(sum(shape)).integers(0, 128, shape)]


def _ernie_inputs(shape):
    ids, types, mask = encoder_batch(*shape, seed=sum(shape))
    return [ids, types, mask]


def _reference_outputs(jm, shapes, names, make, d):
    """{shape: (inputs, the reference's jit.save -> jit.load output)}, one
    reference artifact per shape."""
    out = {}
    for shape in shapes:
        prefix = str(d / f"ref_{shape[0]}x{shape[1]}")
        rpaddle.jit.save(jm, prefix, input_spec=[
            RInputSpec(list(shape), "int64", n) for n in names])
        inputs = make(shape)
        out[shape] = (inputs, _np(rpaddle.jit.load(prefix)(
            *(rpaddle.to_tensor(a) for a in inputs))), prefix)
    return out


@pytest.fixture(scope="module")
def gpt(tmp_path_factory):
    """(port GPT, port prefix, {shape: (inputs, reference output,
    reference prefix)})."""
    d = tmp_path_factory.mktemp("gpt")
    with jax_tiny_gpt(**GPT_KW) as jm:
        tm = torch_tiny_gpt(numpy_state(jm), **GPT_KW).eval()
        prefix = str(d / "port")
        paddle.jit.save(tm, prefix, input_spec=[
            InputSpec([None, None], "int64", "input_ids")])
        yield tm, prefix, _reference_outputs(
            jm, GPT_SHAPES, ("input_ids",), _gpt_inputs, d)


@pytest.fixture(scope="module")
def ernie(tmp_path_factory):
    """As :func:`gpt`, for the ERNIE classifier under a padding mask."""
    d = tmp_path_factory.mktemp("ernie")
    with jax_tiny_encoder() as jm:
        tm = torch_tiny_encoder(numpy_state(jm)).eval()
        prefix = str(d / "port")
        paddle.jit.save(tm, prefix, input_spec=[
            InputSpec([None, None], "int64", n) for n in ERNIE_INPUTS])
        yield tm, prefix, _reference_outputs(
            jm, ERNIE_SHAPES, ERNIE_INPUTS, _ernie_inputs, d)


def _serve(prefix, route, inputs):
    """The port artifact's output on the CPU through ``jit.load`` or a
    predictor."""
    if route == "jit.load":
        layer = paddle.jit.load(prefix, device="cpu")
        return layer(*(torch.from_numpy(a) for a in inputs)).numpy()
    config = inference.Config(prefix)
    config.disable_gpu()
    return inference.create_predictor(config).run(inputs)[0]


@pytest.fixture(params=["sdpa_reference", "flash_plain"])
def cpu_route(request, monkeypatch):
    """The CPU body of the recorded op: the dense route, or the kernels'
    plain versions."""
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU",
                        request.param == "flash_plain")
    return request.param


@pytest.mark.parametrize("route", ["jit.load", "predictor"])
@pytest.mark.parametrize("family", ["gpt", "ernie"])
def test_artifact_matches_reference_at_two_shapes(family, route, cpu_route,
                                                  request):
    _, prefix, refs = request.getfixturevalue(family)
    for inputs, want, _ in refs.values():
        got = _serve(prefix, route, inputs)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["gpt", "ernie"])
def test_exported_graph_records_the_attention_op(family, request):
    tm, prefix, _ = request.getfixturevalue(family)
    graph = paddle.jit.load(prefix, device="cpu").program.graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    layers = tm.config.num_hidden_layers
    assert targets.count("paddle_tpu.attention.default") == layers
    assert not [t for t in targets if "einsum" in t or "softmax" in t]


def test_attention_op_runs_k1_on_cuda_tensors(monkeypatch):
    """The op's CUDA body is K1's wrapper and nothing else: with the
    device test patched to say CUDA, it launches (a stand-in for) K1 once
    and never runs the dense route; on a CPU tensor the dispatcher takes
    the CPU body."""
    launched = []

    def fwd(q, k, v, bias=None, *, causal=False, scale=None):
        launched.append((causal, None if bias is None else bias.shape))
        return fa.flash_attention_forward_plain(q, k, v, bias, causal=causal,
                                                scale=scale)

    def dense(*a, **k):
        raise AssertionError("the dense route ran")

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 4, 8)).astype(
        np.float32)) for _ in range(3))
    mask = torch.zeros((2, 1, 1, 5))
    mask[1, ..., 3:] = -1e9
    want = torch.ops.paddle_tpu.attention(q, k, v, mask, False, None)
    monkeypatch.setattr(fa, "_is_cuda", lambda x: True)
    monkeypatch.setattr(fa, "flash_attention_forward_cuda", fwd)
    monkeypatch.setattr(tattn, "_sdpa_reference", dense)
    got = library._attention_cuda(q, k, v, mask, False, None)
    assert launched == [(False, (2, 1, 1, 5))]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_recording_under_a_sequence_split_raises(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(tattn._ring, "split_group", lambda: object())
    with FakeTensorMode() as mode:
        q = mode.from_tensor(torch.zeros((1, 4, 2, 8)))
        assert library.recording(q)
        with pytest.raises(NotImplementedError, match="A.9b"):
            tattn._sdpa(q, q, q, None, 0.0, True, None, False)


def test_pdiparams_match_reference(gpt):
    _, prefix, refs = gpt
    ref_prefix = refs[GPT_SHAPES[0]][2]
    with open(prefix + ".pdiparams", "rb") as f:
        got = pickle.load(f)
    with open(ref_prefix + ".pdiparams", "rb") as f:
        want = pickle.load(f)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    with open(prefix + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    assert meta["format"] == "torch-export-v1"
    assert meta["state_names"] == list(want)
    assert meta["input_names"] == ["input_ids"]
    with pytest.raises(ValueError, match="stablehlo"):
        paddle.jit.load(ref_prefix, device="cpu")


def test_bf16_weights_travel_as_16_bit_words(tmp_path):
    net = SmallNet(dtype=torch.bfloat16).eval()
    prefix = str(tmp_path / "bf16")
    paddle.jit.save(net, prefix, input_spec=[InputSpec([None, 16],
                                                       "bfloat16")])
    with open(prefix + ".pdiparams", "rb") as f:
        params = pickle.load(f)
    assert {a.dtype for a in params.values()} == {np.dtype(np.int16)}
    loaded = paddle.jit.load(prefix, device="cpu")
    for k, t in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k.replace(".", "__")], t)
    x = torch.from_numpy(_x((3, 16), 4)).to(torch.bfloat16)
    assert torch.equal(loaded(x), net(x))


# ------------------------------------------------------------- to_static


def test_to_static_matches_reference():
    with jax_tiny_gpt(**GPT_KW) as jm:
        tm = torch_tiny_gpt(numpy_state(jm), **GPT_KW).eval()
        before = {n: _np(p).copy() for n, p in jm.named_parameters()}
        rpaddle.jit.to_static(jm)
        paddle.jit.to_static(tm)
        for shape in GPT_SHAPES + GPT_SHAPES[:1]:
            (ids,) = _gpt_inputs(shape)
            np.testing.assert_allclose(
                tm(torch.from_numpy(ids)).detach().numpy(),
                _np(jm(rpaddle.to_tensor(ids))), rtol=RTOL, atol=ATOL)
        assert tm.forward.program_cache_size == 2
        assert jm.forward.program_cache_size == 2

        ids = np.random.default_rng(9).integers(0, 128, (2, 16))
        jm.train()
        opt = rpaddle.optimizer.SGD(learning_rate=1.0,
                                    parameters=jm.parameters())
        RefTrainStep(jm, lambda m, i, l: m(i, labels=l), opt)(
            rpaddle.to_tensor(ids), rpaddle.to_tensor(ids))
        want = {n: before[n] - _np(p) for n, p in jm.named_parameters()}
    tm.train()
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    loss.backward()
    assert tm.forward.program_cache_size == jm.forward.program_cache_size
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    scale = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        err = np.abs(named[n].grad.numpy() - g).max()
        assert err <= GRAD_TOL * scale, (n, err)


def test_enable_to_static_switch():
    net = nn.Linear(4, 4, device="cpu")
    f = paddle.jit.to_static(lambda x: net(x) * 2)
    x = torch.ones((2, 4))
    a = f(x)
    assert f.program_cache_size == 1
    try:
        paddle.jit.enable_to_static(False)
        b = f(torch.ones((3, 4)))
        assert f.program_cache_size == 1
    finally:
        paddle.jit.enable_to_static(True)
    torch.testing.assert_close(a, b[:2], rtol=0, atol=0)


def test_host_sync_falls_back_to_eager():
    @paddle.jit.to_static
    def f(x):
        if float(x.sum().numpy()) > 0:  # host sync inside the trace
            return x * 2.0
        return x - 1.0

    with pytest.warns(UserWarning, match=r"falling back to EAGER.*§A\.9b"):
        out = f(torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])
    # both branches now work (python control flow, eager)
    np.testing.assert_allclose(f(torch.tensor([-1.0, -2.0])).numpy(),
                               [-2.0, -3.0])
    assert f.program_cache_size == 0


def test_save_of_a_traced_function_over_two_layers_raises(tmp_path):
    a, b = nn.Linear(4, 4, device="cpu"), nn.Linear(4, 4, device="cpu")
    f = paddle.jit.to_static(lambda x: b(a(x)))
    with pytest.raises(ValueError, match="spanning 2 layers"):
        paddle.jit.save(f, str(tmp_path / "f"),
                        input_spec=[InputSpec([1, 4])])


# ------------------------------------------------- pool, Config, version


def test_predictor_pool_shares_one_program(gpt):
    _, prefix, _ = gpt
    config = inference.Config(prefix)
    config.disable_gpu()
    pool = inference.PredictorPool(config, size=2)
    a, b = pool.retrieve(0), pool.retrieve(1)
    assert a._layer is b._layer and a is not b
    (x,) = _gpt_inputs(GPT_SHAPES[0])
    np.testing.assert_array_equal(a.run([x])[0], b.run([x])[0])
    assert a.get_input_handle("input_ids") is not b.get_input_handle(
        "input_ids")


def test_config_knobs_and_path_forms():
    from paddle_tpu import inference as rinference

    for mod in (rinference, inference):
        for c in (mod.Config("/m/prefix"), mod.Config("/m/prefix.pdmodel",
                                                     "/m/prefix.pdiparams")):
            assert c.model_dir() == "/m/prefix"
            assert c.prog_file() == "/m/prefix.pdmodel"
            assert c.params_file() == "/m/prefix.pdiparams"
        c = mod.Config()
        c.set_model("/n/p.pdmodel", "/n/p.pdiparams")
        assert c.model_dir() == "/n/p"
        c.switch_ir_optim(False)
        c.enable_memory_optim()
        c.switch_use_feed_fetch_ops(False)
        c.switch_specify_input_names(True)
        c.set_cpu_math_library_num_threads(4)
        assert not c.tensorrt_engine_enabled()
        c.enable_tensorrt_engine(workspace_size=1 << 20)
        assert c.tensorrt_engine_enabled()
        assert not c.decode_engine_enabled()
        c.enable_decode_engine(num_slots=3, max_length=64, page_size=4)
        assert c.decode_engine_enabled()
        ec = c.decode_engine_config()
        assert (ec.num_slots, ec.max_length, ec.page_size, ec.kv_dtype) == (
            3, 64, 4, "f32")
        c.disable_gpu()
        assert not c.use_gpu()
        assert "ir_optim=False" in c.summary()
    c = inference.Config("/m/prefix")
    c.enable_use_gpu(256, 1)
    assert c._device == "cuda:1" and c.memory_pool_init_size_mb() == 256
    c.disable_gpu()
    assert c.device() == torch.device("cpu") and c.gpu_device_id() == -1
    assert "torch" in inference.get_version()
    with pytest.raises(ValueError, match="no model path"):
        inference.create_predictor(inference.Config())


def test_input_spec_repr():
    assert repr(InputSpec([None, 3], "int64", "x")) == repr(
        RInputSpec([None, 3], "int64", "x")) == (
        "InputSpec(shape=[None, 3], dtype=int64, name=x)")
    assert paddle.static.InputSpec is InputSpec
