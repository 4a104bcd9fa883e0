"""Training step (counterpart of ``paddle_tpu/jit/__init__.py``).

``TrainStep(model, loss_fn, optimizer)`` runs one optimizer step per call:
``loss_fn(model, *batch)``, its gradient with respect to the optimizer's
parameters, then ``optimizer.step()``. The reference compiles this into
one XLA program; here it runs eagerly on the device the model lives on.
"""
from __future__ import annotations

from typing import Callable

import torch


class TrainStep:
    """Forward + backward + optimizer update.

    Only the optimizer's parameter list is trained, in its order; other
    parameters of the model are held fixed and get no gradient (the
    reference treats them as buffers). ``__call__`` returns the loss as a
    detached device tensor, with no host sync."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer):
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._params = list(optimizer._parameter_list)

    def __call__(self, *batch):
        trained = [p for p in self._params if p.requires_grad]
        loss = self._loss_fn(self._model, *batch)
        grads = torch.autograd.grad(loss, trained, allow_unused=True)
        for p, g in zip(trained, grads):
            p.grad = g
        self._opt.step()
        for p in trained:
            p.grad = None
        return loss.detach()


__all__ = ["TrainStep"]
