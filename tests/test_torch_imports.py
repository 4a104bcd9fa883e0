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
