"""paddle.static (counterpart of the export part of
``paddle_tpu/static/__init__.py``): ``InputSpec`` and the inference-model
export over ``jit.save`` / ``jit.load``.

The exported program is the traced model, so ``save_inference_model``
needs the model itself (``model=``), as the reference's does. The rest of
``paddle.static`` (``Program``, ``Executor``, ``data``, ``program_guard``,
``static.nn``, ``py_func``, ``gradients``, ``append_backward``, ``Print``
and the control flow) is not ported, see ROADMAP.md §A.9b.
"""
from __future__ import annotations

import torch

from ..jit import InputSpec


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         *, model=None, input_spec=None, **kwargs):
    """Export ``model`` (a Layer; or ``fetch_vars`` when it is one) for
    ``input_spec`` (else ``feed_vars``: ``InputSpec``s or example tensors)
    through ``jit.save``."""
    from .. import jit as _jit

    target = model
    if target is None and isinstance(fetch_vars, torch.nn.Module):
        target = fetch_vars
    if target is None:
        raise ValueError(
            "save_inference_model needs model=<Layer>: the export traces "
            "the model (paddle_tpu_torch.jit.save)")
    spec = input_spec if input_spec is not None else feed_vars
    return _jit.save(target, path_prefix, input_spec=spec)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``(TranslatedLayer, feed names, None)``: the loaded layer plays the
    inference program's part. ``device=`` as in ``jit.load``."""
    from .. import jit as _jit

    layer = _jit.load(path_prefix, **kwargs)
    return layer, layer.input_names, None


__all__ = ["InputSpec", "load_inference_model", "save_inference_model"]
