"""paddle.jit.save / paddle.jit.load (counterpart of
``paddle_tpu/jit/save_load.py``).

``save`` lifts a Layer into a pure function ``(state_list, *inputs) ->
outputs`` (``torch.func.functional_call`` over the Layer's parameters and
buffers), exports it with ``torch.export`` in eval mode and writes the
reference's three files for a path prefix:

  - ``path.pdmodel``:   ``torch.export.save`` of that program. It holds no
    weights: the state comes in as its first argument;
  - ``path.pdiparams``: the pickled ``{name: ndarray}`` of the parameters
    and buffers (protocol 4), the reference's format; a bf16 tensor is
    stored as its 16-bit words (an int16 array) and named ``"bfloat16"``
    in ``state_dtypes`` of the metadata;
  - ``path.pdmeta``:    the pickled metadata: state names and dtypes,
    input names, the output pytree spec and ``format:
    "torch-export-v1"``.

An ``InputSpec`` dim given as ``None`` or -1 is a dynamic dim
(``torch.export.Dim.AUTO``), so one artifact serves several batch sizes
and lengths; two such dims that the program forces equal (ERNIE's
``input_ids`` and ``token_type_ids`` lengths) become one. The trace runs at
example sizes 2 for dim 0 and 16 + j for dim j.

While the export traces, attention is recorded as the op
``paddle_tpu::attention`` (``ops/library.py``), never as a kernel launch or
the plain version's einsums, so a program loaded on the card runs K1 at
every attention node and on the CPU the eager CPU route.

``load`` returns a :class:`TranslatedLayer` on the device asked for (the
card by default): the program moved there with ``move_to_device_pass``
(the trace's device constants included) and the weights as buffers, so
``state_dict()`` round-trips and nothing is trainable.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve_device
from ..framework.dtype import from_host, to_host
from ..nn.layer import Layer
from ..ops import library  # noqa: F401  (registers the op programs call)

_MODEL_SUFFIX = ".pdmodel"
_PARAMS_SUFFIX = ".pdiparams"
_META_SUFFIX = ".pdmeta"
FORMAT = "torch-export-v1"


def _example_size(j):
    """The size a dynamic dim ``j`` is traced at."""
    return 2 if j == 0 else 16 + j


def _state(layer):
    """Names and tensors of the Layer's parameters, then its buffers (the
    reference's order; a tied parameter once)."""
    names, tensors = [], []
    for n, t in list(layer.named_parameters()) + list(layer.named_buffers()):
        names.append(n)
        tensors.append(t.detach())
    return names, tensors


class _Pure(Layer):
    """``forward(state_list, *inputs)``: the Layer's forward on the given
    state. The Layer is held outside the module tree, so the exported
    program lifts no weight of its own."""

    def __init__(self, layer, names):
        super().__init__()
        self._held = (layer,)
        self._names = list(names)

    def forward(self, state, *inputs):
        return torch.func.functional_call(
            self._held[0], dict(zip(self._names, state)), inputs)


def _examples(input_spec, device):
    """Example inputs, the dynamic dims of each and the input names."""
    from . import InputSpec

    examples, dims, names = [], [], []
    for i, spec in enumerate(input_spec):
        if isinstance(spec, InputSpec):
            if spec.shape is None:
                raise ValueError(f"InputSpec {i} has no shape")
            shape = [_example_size(j) if d is None or d < 0 else int(d)
                     for j, d in enumerate(spec.shape)]
            examples.append(torch.zeros(shape, dtype=spec.dtype,
                                        device=device))
            dyn = {j: torch.export.Dim.AUTO
                   for j, d in enumerate(spec.shape) if d is None or d < 0}
            dims.append(dyn or None)
            names.append(spec.name or f"x{i}")
            continue
        t = spec if isinstance(spec, torch.Tensor) else torch.as_tensor(
            np.asarray(spec))
        examples.append(t.detach().to(device))
        dims.append(None)
        names.append(getattr(spec, "name", None) or f"x{i}")
    return examples, dims, names


def _device_of(layer):
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return torch.device("cpu")


def save(layer, path: str, input_spec: Optional[Sequence] = None,
         **configs):
    """paddle.jit.save: export ``layer`` (or the one Layer of a
    ``to_static`` TracedLayer) for ``input_spec`` (``InputSpec``s, example
    tensors or arrays) and write ``path.pdmodel`` / ``.pdiparams`` /
    ``.pdmeta``. The trace runs on the Layer's device, in eval mode."""
    from . import TracedLayer

    if isinstance(layer, TracedLayer):
        # only a TracedLayer over one Layer's forward reduces to a Layer:
        # exporting one of several would serialize the wrong computation
        if len(layer._layers) != 1:
            raise ValueError(
                "jit.save of a traced function spanning "
                f"{len(layer._layers)} layers is ambiguous; wrap the "
                "computation in a single Layer and save that")
        layer = layer._layers[0]
    if not isinstance(layer, torch.nn.Module):
        raise TypeError(f"jit.save expects a Layer, got {type(layer)}")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec=[InputSpec(...), ...]")

    names, state = _state(layer)
    device = _device_of(layer)
    examples, dims, in_names = _examples(input_spec, device)
    was_training = layer.training
    layer.eval()
    try:
        program = torch.export.export(
            _Pure(layer, names), (state, *examples),
            dynamic_shapes=([None] * len(state), tuple(dims)), strict=False)
    finally:
        layer.train(was_training)

    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    # the example inputs would carry the weights into the program's file
    program.example_inputs = None
    with open(path + _MODEL_SUFFIX, "wb") as f:
        torch.export.save(program, f)
    params, dtypes = {}, {}
    for n, t in zip(names, state):
        params[n], dtypes[n] = to_host(t)
    with open(path + _PARAMS_SUFFIX, "wb") as f:
        pickle.dump(params, f, protocol=4)
    meta = {
        "state_names": names,
        "state_dtypes": dtypes,
        "input_names": in_names,
        "out_tree": pytree.treespec_dumps(program.call_spec.out_spec),
        "format": FORMAT,
    }
    with open(path + _META_SUFFIX, "wb") as f:
        pickle.dump(meta, f, protocol=4)
    return path


def _from_array(arr, name, device):
    """A stored array as a tensor: int16 words named ``"bfloat16"`` (or
    an ``ml_dtypes`` bfloat16 array, the reference's) become bf16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr, name = arr.view(np.int16), "bfloat16"
    return from_host(arr, name, device)


class TranslatedLayer(Layer):
    """paddle.jit.load's product: a Layer whose forward runs the loaded
    program on its device, its weights held as buffers (named with
    ``.`` as ``__``, as in the reference)."""

    def __init__(self, program, params_np, meta, device=None):
        super().__init__()
        from torch.export.passes import move_to_device_pass

        self._device = resolve_device(device)
        self._meta = meta
        dtypes = meta.get("state_dtypes", {})
        self._keys = []
        for n in meta["state_names"]:
            key = n.replace(".", "__")
            self.register_buffer(key, _from_array(params_np[n], dtypes.get(n),
                                                  self._device))
            self._keys.append(key)
        program = move_to_device_pass(program, self._device)
        # held outside the module tree: the program's own state is not the
        # layer's
        self._held = (program, program.module())

    @property
    def input_names(self) -> List[str]:
        return list(self._meta["input_names"])

    @property
    def program(self):
        """The ``torch.export`` program, on this layer's device."""
        return self._held[0]

    def _input(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self._device)

    def forward(self, *inputs):
        state = [self._buffers[k] for k in self._keys]
        with torch.no_grad():
            return self._held[1](state, *(self._input(x) for x in inputs))


def load(path: str, device=None, **configs) -> TranslatedLayer:
    """paddle.jit.load: the :class:`TranslatedLayer` of ``path``'s three
    files, on ``device`` (the default device: the card unless
    ``set_device("cpu")``)."""
    with open(path + _META_SUFFIX, "rb") as f:
        meta = pickle.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path}{_META_SUFFIX} has format {meta.get('format')!r}, not "
            f"{FORMAT!r}: a StableHLO artifact of the JAX package does not "
            "load here")
    dev = resolve_device(device)
    with open(path + _MODEL_SUFFIX, "rb") as f:
        program = torch.export.load(f)
    with open(path + _PARAMS_SUFFIX, "rb") as f:
        params_np = pickle.load(f)
    return TranslatedLayer(program, params_np, meta, dev)


__all__ = ["FORMAT", "TranslatedLayer", "load", "save"]
