"""paddle.inference (counterpart of ``paddle_tpu/inference/__init__.py``):
the predictor over a ``jit.save`` artifact, and the serving engine.

``Config(prefix)`` names the three files ``jit.save`` wrote;
``create_predictor(config)`` loads them (``jit.load``) on the config's
device: the card (``cuda:device_id``, ``enable_use_gpu``'s default
device 0) unless ``disable_gpu()`` asked for the CPU, or ``set_device``
made the CPU the default. On the card every attention node of the loaded
program runs the flash-attention kernel K1. The reference's analysis
passes are its XLA compile, so the optimization and TensorRT switches are
accepted and recorded, as there. The predictor's handles follow the
reference's zero-copy API: an input is uploaded to the device when it
changed since the last ``run()`` and stays there; outputs stay on the
device until ``copy_to_cpu()``.

``enable_decode_engine(model, config)`` attaches the KV-cached
``DecodeEngine`` (K3 on the card) built from
``config.enable_decode_engine(...)``'s settings.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve_device
from ..jit.save_load import TranslatedLayer, load as _jit_load
from .engine import (DecodeEngine, EngineConfig, PagePool, PrefixRegistry,
                     SamplingParams, pow2_bucket)

_MODEL_SUFFIX = ".pdmodel"


def _prefix(path):
    if path is not None and path.endswith(_MODEL_SUFFIX):
        return path[: -len(_MODEL_SUFFIX)]
    return path


class Config:
    """paddle.inference.Config: the model's path prefix (as ``jit.save``
    wrote it, with or without ``.pdmodel``, in either slot), the device,
    and the knobs, recorded."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._prefix = _prefix(prog_file)
        self._memory_optim = True
        self._ir_optim = True
        #: None: the default device (the card unless set_device("cpu"))
        self._device = None
        self._memory_pool_mb = 100
        self._num_threads = 1
        self._tensorrt = False
        self._engine_kwargs = None

    # --- model location ---
    def set_model(self, prog_file, params_file=None):
        self._prefix = _prefix(prog_file)

    def model_dir(self):
        return self._prefix

    def prog_file(self):
        return (self._prefix or "") + _MODEL_SUFFIX

    def params_file(self):
        return (self._prefix or "") + ".pdiparams"

    # --- device selection ---
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on CUDA device ``device_id``; the pool size is recorded."""
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self.device().type == "cuda"

    def gpu_device_id(self):
        dev = self.device()
        return dev.index if dev.type == "cuda" else -1

    def memory_pool_init_size_mb(self):
        return self._memory_pool_mb

    def device(self) -> torch.device:
        """The device the predictor runs on."""
        return resolve_device(self._device)

    def set_cpu_math_library_num_threads(self, n):
        self._num_threads = n

    # --- optimization knobs (recorded, as in the reference) ---
    def enable_memory_optim(self, x=True):
        self._memory_optim = x

    def switch_ir_optim(self, x=True):
        self._ir_optim = x

    def switch_use_feed_fetch_ops(self, x=False):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def enable_tensorrt_engine(self, *args, **kwargs):
        self._tensorrt = True

    def tensorrt_engine_enabled(self):
        return self._tensorrt

    # --- the serving decode engine ---
    def enable_decode_engine(self, num_slots: int = 8, max_length: int = 512,
                             kv_dtype: str = "f32", **kw):
        """Record ``EngineConfig`` settings for the module-level
        :func:`enable_decode_engine`."""
        self._engine_kwargs = dict(num_slots=num_slots, max_length=max_length,
                                   kv_dtype=kv_dtype, **kw)

    def decode_engine_enabled(self) -> bool:
        return self._engine_kwargs is not None

    def decode_engine_config(self) -> EngineConfig:
        """The ``EngineConfig`` of :meth:`enable_decode_engine`'s
        settings."""
        return EngineConfig(**(self._engine_kwargs or {}))

    def summary(self):
        return (f"Config(prefix={self._prefix}, device="
                f"{self._device or 'default'}, memory_optim="
                f"{self._memory_optim}, ir_optim={self._ir_optim})")


class _IOHandle:
    """A named input or output (the reference's ``ZeroCopyTensor``):
    ``copy_from_cpu`` stages a host array, ``copy_to_cpu`` reads the
    device value back."""

    def __init__(self, name):
        self.name = name
        self._value = None
        self._shape = None
        #: bumped by every copy_from_cpu: run() uploads an input only when
        #: its version moved
        self._version = 0

    def reshape(self, shape):
        self._shape = tuple(shape)

    def copy_from_cpu(self, arr):
        arr = np.asarray(arr)
        if self._shape is not None and tuple(arr.shape) != self._shape:
            arr = arr.reshape(self._shape)
        self._value = arr
        self._version += 1

    def copy_to_cpu(self) -> np.ndarray:
        """The value as a host array (a bf16 output as float32, which
        holds it exactly)."""
        v = self._value
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                v = v.float()
            return v.cpu().numpy()
        return np.asarray(v)

    def shape(self):
        v = self._value
        return list(v.shape) if v is not None else list(self._shape or [])


class Predictor:
    """paddle.inference's predictor over a ``jit.save`` artifact."""

    def __init__(self, config: Config,
                 _layer: Optional[TranslatedLayer] = None):
        if _layer is None and not config._prefix:
            raise ValueError("Config has no model path; use Config(prefix) "
                             "or set_model")
        self._config = config
        self._layer = (_layer if _layer is not None
                       else _jit_load(config._prefix, config.device()))
        self._device = self._layer._device
        self._input_names = self._layer.input_names
        self._inputs: Dict[str, _IOHandle] = {
            n: _IOHandle(n) for n in self._input_names}
        self._outputs: Dict[str, _IOHandle] = {}
        self._output_names: List[str] = []
        #: name -> (handle version, the value on the device)
        self._dev_inputs: Dict[str, tuple] = {}

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name) -> _IOHandle:
        return self._inputs[name]

    def _device_input(self, name):
        """The handle's value on the device, uploaded again only when
        ``copy_from_cpu`` bumped its version since the last run."""
        h = self._inputs[name]
        ver, t = self._dev_inputs.get(name, (None, None))
        if ver != h._version:
            v = h._value
            t = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v)))
            t = t.to(self._device)
            self._dev_inputs[name] = (h._version, t)
        return t

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run on the staged handles, or on ``inputs`` given positionally
        (then the outputs come back as host arrays)."""
        if inputs is not None:
            if len(inputs) != len(self._input_names):
                raise ValueError(
                    f"run() got {len(inputs)} inputs, model expects "
                    f"{len(self._input_names)}: {self._input_names}")
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        missing = [n for n in self._input_names
                   if self._inputs[n]._value is None]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        out = self._layer(*[self._device_input(n)
                            for n in self._input_names])
        leaves = [x for x in pytree.tree_leaves(out)
                  if isinstance(x, torch.Tensor)]
        self._output_names = [f"fetch_{i}" for i in range(len(leaves))]
        self._outputs = {}
        for n, leaf in zip(self._output_names, leaves):
            h = _IOHandle(n)
            h._value = leaf  # stays on the device until copy_to_cpu
            self._outputs[n] = h
        if inputs is not None:
            return [self._outputs[n].copy_to_cpu()
                    for n in self._output_names]
        return True

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_output_handle(self, name) -> _IOHandle:
        return self._outputs[name]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """paddle.inference.PredictorPool: ``size`` predictors over ONE loaded
    program and one copy of its weights; each has its own handles."""

    def __init__(self, config: Config, size: int = 1):
        shared = _jit_load(config._prefix, config.device())
        self._preds = [Predictor(config, _layer=shared) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]


def get_version():
    return f"paddle_tpu_torch-inference (torch {torch.__version__})"


def enable_decode_engine(model, config: Optional[Config] = None, **kw):
    """Attach a KV-cached continuous-batching ``DecodeEngine`` to a causal
    LM exposing ``decode_adapter()`` (GPTForCausalLM, LlamaForCausalLM).
    After this, ``text.generation.generate`` / ``generate_padded`` route
    through the engine (the paged-attention kernel K3 on the card); the
    engine is also returned for direct ``submit()`` / ``step()`` /
    ``run()`` driving. Its settings are ``config.enable_decode_engine(...)``'s
    on ``config``'s device when a ``Config`` with them is given, else the
    keyword arguments (``EngineConfig`` fields, ``device``)."""
    if config is not None and config.decode_engine_enabled():
        engine = DecodeEngine(model, config.decode_engine_config(),
                              device=config.device())
    else:
        if config is not None:
            kw.setdefault("device", config.device())
        engine = DecodeEngine(model, **kw)
    model._decode_engine = engine
    return engine


def disable_decode_engine(model):
    """Detach the engine; generation falls back to the loops."""
    if getattr(model, "_decode_engine", None) is not None:
        model._decode_engine = None


__all__ = ["Config", "DecodeEngine", "EngineConfig", "PagePool", "Predictor",
           "PredictorPool", "PrefixRegistry", "SamplingParams",
           "create_predictor", "disable_decode_engine",
           "enable_decode_engine", "get_version", "pow2_bucket"]
