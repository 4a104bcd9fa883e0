"""Training step (counterpart of ``paddle_tpu/jit/__init__.py``).

``TrainStep(model, loss_fn, optimizer)`` runs one optimizer step per call:
``loss_fn(model, *batch)``, its gradient with respect to the optimizer's
parameters, then ``optimizer.step()``. The reference compiles this into
one XLA program; here it runs eagerly on the device the model lives on. A
batch of placed tensors (``DTensor``s of ``paddle.distributed``, what
``shard_dataloader`` yields) runs on this rank's local blocks: rows split
over a data axis make the loss's batch-coupled reductions count over its
group (``nn.functional.loss.split_batch``), and the optimizer
``parallelize`` / ``to_distributed`` return averages the gradients there.
``repeat`` / ``run_steps`` run several steps (the reference scans them in
one program; here they loop over ``__call__``), the learning rate held as
it is through the window (nothing steps the scheduler inside it).
``cost_analysis`` / ``memory_analysis`` read the reference's compiled XLA
program and are not ported (ROADMAP.md §A.3).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch


class TrainStep:
    """Forward + backward + optimizer update.

    Only the optimizer's parameter list is trained, in its order; other
    parameters of the model are held fixed and get no gradient (the
    reference treats them as buffers). ``__call__`` returns the loss as a
    detached device tensor, with no host sync. ``donate`` (the reference's
    XLA buffer donation) is accepted and recorded: an eager step has no
    buffers to donate."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate=True):
        self._donate = donate
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._params = list(optimizer._parameter_list)

    def __call__(self, *batch):
        trained = [p for p in self._params if p.requires_grad]
        scope = contextlib.nullcontext()
        if any(type(v).__name__ == "DTensor" for v in batch):
            from ..distributed.auto_parallel import local_inputs
            from ..nn.functional.loss import split_batch

            batch, _, group = local_inputs(batch)
            scope = split_batch(group)
        with scope:
            loss = self._loss_fn(self._model, *batch)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        for p, g in zip(trained, grads):
            p.grad = g
        self._opt.step()
        for p in trained:
            p.grad = None
        return loss.detach()

    def repeat(self, n, *batch):
        """``n`` steps on the same batch; the losses as one ``[n]``
        tensor."""
        return torch.stack([self(*batch) for _ in range(int(n))])

    def run_steps(self, *stacked_batch):
        """One step per slice of dim 0 of every batch argument (each must
        have ``n`` of them); the ``[n]`` losses."""
        n = int(stacked_batch[0].shape[0])
        short = [i for i, v in enumerate(stacked_batch)
                 if v.dim() == 0 or v.shape[0] != n]
        if short:
            raise ValueError(
                f"run_steps: batch args {short} have leading axis "
                f"{[tuple(stacked_batch[i].shape)[:1] for i in short]} != "
                f"{n} (every arg must stack one slice per step)")
        return torch.stack([self(*(v[i] for v in stacked_batch))
                            for i in range(n)])

    def cost_analysis(self, *batch):
        raise NotImplementedError(
            "TrainStep.cost_analysis reads a compiled XLA program; not "
            "ported, see ROADMAP.md §A.3")

    def memory_analysis(self, *batch):
        raise NotImplementedError(
            "TrainStep.memory_analysis reads a compiled XLA program; not "
            "ported, see ROADMAP.md §A.3")


__all__ = ["TrainStep"]
