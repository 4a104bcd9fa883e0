"""The top-level namespace of the PyTorch port (``import paddle_tpu_torch
as paddle``) against ``paddle_tpu``'s on the CPU: the exported names and
dtype names, ``to_tensor``'s dtype rules, ``seed`` and the RNG state,
``set_device`` / ``get_device`` (the default device that layers,
``DataLoader`` and ``DecodeEngine`` follow), and the body of
``examples/train_vision_hapi.py`` run on the port after
``set_device("cpu")``. Every test that sets the default device restores
it (``default_device``): the test files share one process under xdist.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as tdevice

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "train_vision_hapi.py"
IMPORT_LINE = "import paddle_tpu as paddle\n"

SUBPACKAGES = ["amp", "device", "distributed", "incubate", "inference", "io",
               "jit", "metric", "nn", "optimizer", "tensor", "text",
               "vision"]
DTYPE_NAMES = ["bool", "uint8", "int8", "int16", "int32", "int64",
               "float16", "bfloat16", "float32", "float64", "complex64",
               "complex128"]
FUNCTIONS = ["seed", "get_rng_state", "set_rng_state", "to_tensor",
             "set_device", "get_device", "no_grad", "enable_grad",
             "set_grad_enabled", "is_grad_enabled", "Model", "save", "load",
             "add", "multiply", "divide", "clip", "sum", "mean", "exp", "log",
             "matmul", "bmm", "reshape", "transpose", "flatten", "t",
             "repeat_interleave"]


@pytest.fixture
def default_device():
    """Restore the port's default device after the test."""
    prev = tdevice._default
    yield
    tdevice._default = prev


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_exported_names_match_the_reference():
    for name in SUBPACKAGES + DTYPE_NAMES + FUNCTIONS:
        assert hasattr(paddle, name), name
        assert hasattr(paddle_tpu, name), name
        assert name in paddle.__all__, name
    for name in DTYPE_NAMES:
        got = getattr(paddle, name)
        assert isinstance(got, torch.dtype)
        assert str(got) == f"torch.{name}"
        assert np.dtype(getattr(paddle_tpu, name)).name == name
    assert paddle.no_grad is torch.no_grad
    assert paddle.nn.functional.decode_attention is not None
    assert paddle.inference.enable_decode_engine is not None
    assert paddle.text.generation.generate is not None


@pytest.mark.parametrize("data, dtype", [
    (np.arange(6, dtype=np.float64).reshape(2, 3) / 7, None),
    (np.ones(3, np.float32), None),
    (np.ones(3, np.float16), None),
    (np.arange(3, dtype=np.int32), None),
    (np.array([True, False]), None),
    ([1.5, 2.5], None),
    (2.5, None),
    (np.arange(3, dtype=np.float64), "float16"),
    (np.arange(3, dtype=np.float32), "bfloat16"),
    (np.arange(3, dtype=np.float32), "int32"),
    ([[1, 2], [3, 4]], "float32"),
], ids=["f64", "f32", "f16", "i32", "bool", "list", "scalar", "to-f16",
        "to-bf16", "to-i32", "list-to-f32"])
def test_to_tensor_dtype_rules_match_reference(data, dtype, default_device):
    paddle.set_device("cpu")
    want = paddle_tpu.to_tensor(data, dtype=dtype)
    got = paddle.to_tensor(data, dtype=dtype)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype("float32")))
    assert got.device.type == "cpu"
    assert not got.requires_grad


def test_to_tensor_from_a_tensor_and_stop_gradient(default_device):
    """A tensor is copied (and cast); ``stop_gradient=False`` on a float
    tensor sets ``requires_grad``, as the reference clears
    ``stop_gradient``. 64-bit ints stay int64 (Paddle's rule), where JAX,
    its 64-bit types off, narrows the reference's to int32."""
    paddle.set_device("cpu")
    src = torch.arange(4, dtype=torch.float32)
    got = paddle.to_tensor(src, dtype="float16")
    assert got.dtype == torch.float16
    got = paddle.to_tensor(src)
    got[0] = 7.0
    assert src[0] == 0.0
    x = np.ones((2, 2), np.float32)
    assert paddle.to_tensor(x, stop_gradient=False).requires_grad
    assert not paddle_tpu.to_tensor(x, stop_gradient=False).stop_gradient
    assert not paddle.to_tensor(np.arange(3), stop_gradient=False) \
        .requires_grad
    assert paddle.to_tensor(np.arange(3)).dtype == torch.int64
    assert str(paddle_tpu.to_tensor(np.arange(3)).dtype) == "int32"
    assert paddle.to_tensor(x, place="cpu").device.type == "cpu"


def test_seed_makes_runs_repeat(default_device):
    paddle.set_device("cpu")

    def run():
        lin = paddle.nn.Linear(8, 4)
        x = torch.ones(16, 8)
        return lin.weight.detach().clone(), paddle.nn.functional.dropout(
            x, 0.5, training=True)

    paddle.seed(123)
    a = run()
    paddle.seed(123)
    b = run()
    paddle.seed(124)
    c = run()
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    state = paddle.get_rng_state()
    d = run()
    paddle.set_rng_state(state)
    e = run()
    for u, v in zip(d, e):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_set_device_and_get_device(default_device):
    """``set_device("cpu")`` is the default of every entry point: layers
    built with ``device=None``, a model, ``DataLoader``, ``DecodeEngine``
    and ``to_tensor``; ``get_device`` reports it."""
    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    assert paddle.set_device("cpu") == torch.device("cpu")
    assert paddle.get_device() == "cpu"
    assert paddle.resolve_device() == torch.device("cpu")
    assert paddle.nn.Linear(2, 3).weight.device.type == "cpu"
    bn = paddle.nn.BatchNorm2D(3)
    assert bn._mean.device.type == "cpu" and bn.weight.device.type == "cpu"
    assert paddle.nn.LayerNorm(4).weight.device.type == "cpu"
    model = GPTForCausalLM(GPTConfig(
        vocab_size=11, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=32))
    assert next(model.parameters()).device.type == "cpu"
    assert DecodeEngine(model, max_length=32, num_slots=1).device.type \
        == "cpu"
    assert DataLoader([np.zeros(2, np.float32)]).device.type == "cpu"
    assert paddle.to_tensor([1.0]).device.type == "cpu"
    # an explicit device still wins over the default
    assert paddle.resolve_device("cpu") == torch.device("cpu")
    for bad in ("xpu", "tpu:0", "cpu:1", "npu"):
        with pytest.raises(ValueError, match="unsupported device"):
            paddle.set_device(bad)
    assert paddle.get_device() == "cpu"


def test_set_device_gpu_raises_without_cuda(no_cuda, default_device):
    """The reference maps "gpu" to whatever device it has; the port does
    not fall back: without CUDA "gpu" / "gpu:0" / "cuda" raise, the
    default is left as it was, and before any ``set_device`` the default
    device (the card) raises on use."""
    tdevice._default = None
    for name in ("gpu", "gpu:0", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.set_device(name)
    assert tdevice._default is None
    assert paddle.get_device() == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.nn.Linear(2, 3)


class _Recorder:
    """Stands in for ``paddle.Model`` while the example runs: records each
    model and what its ``predict_batch`` returned."""

    def __init__(self, model_cls):
        rec = self

        class Model(model_cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.models.append(self)

            def predict_batch(self, inputs):
                out = super().predict_batch(inputs)
                rec.predicted.append((inputs, out))
                return out

        self.cls = Model
        self.models, self.predicted = [], []


def test_vision_hapi_example_runs_on_the_port(monkeypatch, default_device,
                                              capsys):
    """The example's source with its one ``import paddle_tpu as paddle``
    line replaced in memory by the port's import (the file itself is only
    read), run with ``set_device("cpu")``: fit, evaluate, predict and
    summary run; the logits are finite and every parameter is on the CPU.
    The example's JAX preamble runs only under ``JAX_PLATFORMS=cpu``,
    which is unset for the run."""
    src = EXAMPLE.read_text()
    assert src.count(IMPORT_LINE) == 1
    src = src.replace(IMPORT_LINE, "import paddle_tpu_torch as paddle\n")
    paddle.set_device("cpu")
    rec = _Recorder(paddle.Model)
    monkeypatch.setattr(paddle, "Model", rec.cls)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    ns = {"__name__": "train_vision_hapi", "__file__": str(EXAMPLE)}
    exec(compile(src, str(EXAMPLE), "exec"), ns)
    assert ns["paddle"] is paddle
    ns["main"]()
    out = capsys.readouterr().out
    assert "eval:" in out and "Total params: 1,562" in out
    (model,) = rec.models
    (inputs, (logits,)), = rec.predicted
    assert inputs[0].device.type == "cpu"
    assert logits.shape == (4, 10) and np.isfinite(logits).all()
    params = list(model.network.parameters())
    assert params and all(p.device.type == "cpu" for p in params)
    assert all(torch.isfinite(p).all() for p in params)
