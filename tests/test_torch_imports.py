"""Guards of the PyTorch port: it never imports JAX or the reference
package, and it never falls back to the CPU on its own."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.inference.engine import DecodeEngine
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), (path, name)


def test_distributed_modules_are_covered():
    """The guard's module list holds every distributed module, the ZeRO-3
    layout, the mp wire, the auto-parallel / reshard / checkpoint modules,
    the serving tier (store, chaos, telemetry, serving), the launcher,
    watchdog, elastic, MPMD, rpc and ps modules, the live plane, the
    planner and the supervisor, and the collective-traffic analysis and
    the decode engine's mp slicing among them."""
    for m in ("paddle_tpu_torch.distributed.mp_comm",
              "paddle_tpu_torch.distributed.grad_comm",
              "paddle_tpu_torch.distributed.fleet.meta_parallel."
              "sharding_stage3",
              "paddle_tpu_torch.distributed.mesh",
              "paddle_tpu_torch.distributed.auto_parallel",
              "paddle_tpu_torch.distributed.parallelize",
              "paddle_tpu_torch.distributed.reshard",
              "paddle_tpu_torch.distributed.checkpoint",
              "paddle_tpu_torch.distributed.checkpoint.converter",
              "paddle_tpu_torch.distributed.checkpoint.manifest",
              "paddle_tpu_torch.runtime",
              "paddle_tpu_torch.runtime.py_store",
              "paddle_tpu_torch.testing",
              "paddle_tpu_torch.testing.chaos",
              "paddle_tpu_torch.observability",
              "paddle_tpu_torch.observability.metrics",
              "paddle_tpu_torch.observability.tracing",
              "paddle_tpu_torch.observability.catalog",
              "paddle_tpu_torch.observability.accounting",
              "paddle_tpu_torch.serving",
              "paddle_tpu_torch.serving.protocol",
              "paddle_tpu_torch.serving.transport",
              "paddle_tpu_torch.serving.worker",
              "paddle_tpu_torch.serving.router",
              "paddle_tpu_torch.runtime.watchdog",
              "paddle_tpu_torch.distributed.launch",
              "paddle_tpu_torch.distributed.launch.__main__",
              "paddle_tpu_torch.distributed.fleet.elastic",
              "paddle_tpu_torch.distributed.mpmd",
              "paddle_tpu_torch.distributed.rpc",
              "paddle_tpu_torch.distributed.ps",
              "paddle_tpu_torch.distributed.ps.geo",
              "paddle_tpu_torch.observability.live",
              "paddle_tpu_torch.observability.fleet",
              "paddle_tpu_torch.distributed.auto_parallel.planner",
              "paddle_tpu_torch.distributed.fleet.supervisor",
              "paddle_tpu_torch.distributed.comm_analysis",
              "paddle_tpu_torch.text.models._mp_decode"):
        assert m in MODULES, m


def test_import_leaves_jax_unloaded():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "print(len(bad)); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny(device):
    return GPTForCausalLM(GPTConfig(
        vocab_size=11, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=32), device=device)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_engine_without_device_raises_on_cpu_only_machine(no_cuda):
    model = _tiny("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(model, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tiny(None)


def test_engine_refuses_model_on_another_device():
    model = _tiny("cpu").to("meta")
    with pytest.raises(ValueError, match="engine runs on cpu"):
        DecodeEngine(model, device="cpu")


def test_engine_rejects_unknown_attention_choice():
    with pytest.raises(ValueError, match="attn_kernel"):
        DecodeEngine(_tiny("cpu"), device="cpu", attn_kernel="einsum")


def test_encoders_and_loader_without_device_raise_on_cpu_only_machine(
        no_cuda):
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.text.models.bert import BertConfig, BertModel
    from paddle_tpu_torch.text.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification)

    tiny = dict(vocab_size=11, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ErnieForSequenceClassification(ErnieConfig(**tiny))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertModel(BertConfig(**tiny))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataLoader([1, 2, 3])
    assert BertModel(BertConfig(**tiny), device="cpu").pooler is not None


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.nn.functional.conv", "paddle_tpu_torch.nn.layers.conv",
    "paddle_tpu_torch.nn.layers.pooling",
    "paddle_tpu_torch.nn.layers.activation",
    "paddle_tpu_torch.vision", "paddle_tpu_torch.vision.models.resnet",
    "paddle_tpu_torch.vision.transforms",
    "paddle_tpu_torch.vision.datasets"])
def test_vision_modules_are_guarded(module):
    """The vision slice's modules are among those the guards above walk."""
    assert module in MODULES


def test_resnet_without_device_raises_on_cpu_only_machine(no_cuda):
    from paddle_tpu_torch.vision.models import resnet18

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet18()
    assert next(resnet18(device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch", "paddle_tpu_torch.device",
    "paddle_tpu_torch.framework.dtype", "paddle_tpu_torch.framework.rng",
    "paddle_tpu_torch.tensor.creation", "paddle_tpu_torch.text.generation",
    "paddle_tpu_torch.inference", "paddle_tpu_torch.nn.functional.attention",
    "paddle_tpu_torch.text.models.gpt", "paddle_tpu_torch.text.models.llama"])
def test_generation_and_namespace_modules_are_guarded(module):
    """The generation slice's modules and the top-level namespace are
    among those the guards above walk."""
    assert module in MODULES


def test_generation_without_device_raises_on_cpu_only_machine(no_cuda):
    """The namespace's entry points default to the card too."""
    import paddle_tpu_torch as paddle

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.to_tensor([1, 2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.inference.enable_decode_engine(_tiny("cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.set_device("gpu")


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.jit", "paddle_tpu_torch.jit.save_load",
    "paddle_tpu_torch.static", "paddle_tpu_torch.ops.library"])
def test_deployment_modules_are_guarded(module):
    """The deployment slice's modules (``jit.save`` / ``load``,
    ``paddle.static``'s export, the op that export records) are among
    those the guards above walk."""
    assert module in MODULES


def test_deployment_without_device_raises_on_cpu_only_machine(no_cuda,
                                                               tmp_path):
    """A saved model loads on the card unless the CPU is asked for."""
    import paddle_tpu_torch as paddle

    prefix = str(tmp_path / "tiny")
    paddle.jit.save(_tiny("cpu"), prefix, input_spec=[
        paddle.jit.InputSpec([None, None], "int64")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.jit.load(prefix)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.inference.create_predictor(paddle.inference.Config(prefix))
    config = paddle.inference.Config(prefix)
    config.enable_use_gpu(100, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.inference.PredictorPool(config, 2)
    config.disable_gpu()
    assert paddle.inference.create_predictor(config).run(
        [[[1, 2, 3]]])[0].shape == (1, 3, 11)


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.nn.layer", "paddle_tpu_torch.tensor.creation",
    "paddle_tpu_torch.tensor.logic", "paddle_tpu_torch.tensor.random",
    "paddle_tpu_torch.tensor.manipulation", "paddle_tpu_torch.tensor.math",
    "paddle_tpu_torch.tensor.linalg"])
def test_layer_and_tensor_modules_are_guarded(module):
    """The ``nn.Layer`` / tensor-API slice's modules are among those the
    guards above walk."""
    assert module in MODULES


@pytest.mark.parametrize("call", [
    lambda p: p.zeros([2]), lambda p: p.ones([2], "int32"),
    lambda p: p.full([2], 1.5), lambda p: p.arange(3),
    lambda p: p.linspace(0, 1, 3), lambda p: p.eye(2),
    lambda p: p.tril_indices(3, 3), lambda p: p.rand([2]),
    lambda p: p.randn([2]), lambda p: p.randint(0, 5, [2]),
    lambda p: p.randperm(4), lambda p: p.uniform([2], seed=3),
    lambda p: p.nn.Layer().create_parameter([2])],
    ids=["zeros", "ones", "full", "arange", "linspace", "eye",
         "tril_indices", "rand", "randn", "randint", "randperm",
         "uniform-seed", "create_parameter"])
def test_creation_without_device_raises_on_cpu_only_machine(no_cuda, call):
    """A creation or random function given no device creates on the
    default device: without CUDA it raises, as the namespace's entry points
    do, and never falls back to the CPU."""
    import paddle_tpu_torch as paddle

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(paddle)


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.distributed", "paddle_tpu_torch.distributed.env",
    "paddle_tpu_torch.distributed.collective",
    "paddle_tpu_torch.distributed.communication",
    "paddle_tpu_torch.distributed.parallel",
    "paddle_tpu_torch.distributed.grad_comm",
    "paddle_tpu_torch.distributed.sharding",
    "paddle_tpu_torch.distributed.fleet",
    "paddle_tpu_torch.distributed.fleet.strategy",
    "paddle_tpu_torch.distributed.fleet.topology",
    "paddle_tpu_torch.distributed.fleet.layers",
    "paddle_tpu_torch.distributed.fleet.layers.mpu",
    "paddle_tpu_torch.distributed.fleet.utils",
    "paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util",
    "paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils",
    "paddle_tpu_torch.distributed.fleet.meta_parallel",
    "paddle_tpu_torch.distributed.fleet.meta_parallel.tensor_parallel",
    "paddle_tpu_torch.distributed.fleet.meta_parallel.sharding"])
def test_distributed_modules_are_guarded(module):
    """The distributed slice's modules are among those the guards above
    walk."""
    assert module in MODULES


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.nn.functional.ring_attention",
    "paddle_tpu_torch.incubate.moe",
    "paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils"])
def test_sep_and_expert_modules_are_guarded(module):
    """The sep axis's and expert parallelism's modules are among those the
    guards above walk."""
    assert module in MODULES


def test_distributed_entry_points_default_to_the_card(no_cuda):
    """``init_parallel_env`` picks NCCL on the default device, the card:
    without CUDA it raises instead of switching to gloo on the CPU, and so
    does an explicit NCCL; ``fleet.init`` goes through it."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.init_parallel_env()
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.init_parallel_env(backend="nccl")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet.init(is_collective=True)
    assert not dist.is_initialized()
    assert not torch.distributed.is_initialized()


ZOO_MODULES = ["alexnet", "densenet", "googlenet", "inceptionv3", "lenet",
               "mobilenet", "mobilenetv3", "shufflenetv2", "squeezenet",
               "vgg", "vit", "_common"]


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.nn.layers.transformer",
    "paddle_tpu_torch.nn.functional.activation"]
    + [f"paddle_tpu_torch.vision.models.{m}" for m in ZOO_MODULES])
def test_zoo_and_transformer_modules_are_guarded(module):
    """The vision zoo's modules, ``nn.Transformer``'s and the activations'
    are among those the guards above walk."""
    assert module in MODULES


@pytest.mark.parametrize("builder", ["LeNet", "alexnet", "vgg11",
                                     "squeezenet1_1", "mobilenet_v3_small",
                                     "densenet121", "vit_b_16"])
def test_zoo_without_device_raises_on_cpu_only_machine(no_cuda, builder):
    from paddle_tpu_torch.vision import models

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(models, builder)()


def test_transformer_without_device_raises_on_cpu_only_machine(no_cuda):
    from paddle_tpu_torch import nn

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.MultiHeadAttention(16, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.Transformer(16, 2, 1, 1, 32)


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.serving.frontier", "paddle_tpu_torch.serving.replay",
    "paddle_tpu_torch.runtime.native", "paddle_tpu_torch.profiler",
    "paddle_tpu_torch.hapi.callbacks"])
def test_front_tier_and_host_runtime_modules_are_guarded(module):
    """The front tier, the replay, the host runtime's loader and the
    profiler are among the modules the guards above walk."""
    assert module in MODULES


def test_host_runtime_builds_from_the_port_s_own_source():
    """The port's native library is built from its own copy of the C++
    (``runtime/csrc/``), never from the repo's ``csrc/``."""
    from paddle_tpu_torch.runtime import native

    assert Path(native._SRC).is_relative_to(PORT / "runtime" / "csrc")
    for path in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "paddle_tpu_rt" not in text, path
        assert '"csrc"' not in text or path == PORT / "runtime" / "native.py", path
