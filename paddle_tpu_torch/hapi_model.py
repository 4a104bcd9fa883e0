"""High-level training API, ``paddle.Model`` (counterpart of
``paddle_tpu/hapi_model.py``).

``prepare`` / ``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load``
with callbacks and metrics, as in the reference. The train step is the
port's ``jit.TrainStep`` (eager forward, ``autograd.grad``, the optimizer
in place); evaluation and prediction run the network in eval mode under
``torch.no_grad``. A batch's last field is the label, the others the
network's inputs. Data given as a dataset is loaded by ``io.DataLoader``
onto the network's device.

With ``fleet.init`` over more than one rank, ``prepare`` routes the
network through ``fleet.distributed_model``, the optimizer through
``fleet.distributed_optimizer`` and the step through
``fleet.DistTrainStep`` (each rank is given the global batch; the step
takes its rows and its part of the sequence); a ``PipelineLayer``
network raises, as the reference's does. Without fleet the plain
``TrainStep`` stays. ``comm_traffic`` runs one recorded step on a batch
and reports its collectives (``distributed/comm_analysis.py``).

With telemetry on (``PADDLE_TPU_TELEMETRY_DIR``), ``fit`` probes the
step's FLOPs once through ``TrainStep.cost_analysis`` for the MFU gauge of
``callbacks.TelemetryLogger``, as the reference does; the port's
``cost_analysis`` raises (ROADMAP.md §A.3), so the probe gives None and
the logger exports tokens/s without MFU. The reference accepts
``amp_configs`` and ignores it (ROADMAP.md §C); here a value other than
None raises: run the network under ``amp.auto_cast`` inside the loss
instead.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from . import observability as _obs
from .framework.io_state import load as _load
from .framework.io_state import save as _save
from .framework.io_state import set_state_dict
from .hapi import callbacks as _cb
from .hapi.model_summary import summary as _summary
from .io import DataLoader
from .jit import TrainStep
from .metric import Metric


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host(out):
    """A network output as numpy (bf16 / f16 read as f32)."""
    if not isinstance(out, torch.Tensor):
        return out
    out = out.detach()
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.cpu().numpy()


def _fleet_world() -> int:
    """The ranks of the fleet topology in force (``fleet.init``); 1
    without one, as the reference keeps its plain step on a bare mesh."""
    from .distributed.fleet import get_hybrid_communicate_group
    from .distributed.mesh import get_global_mesh

    mesh = get_global_mesh()
    if get_hybrid_communicate_group() is None or mesh is None:
        return 1
    return len(mesh.process_ids)


def _metric_names(m):
    return m.name() if isinstance(m.name(), list) else [m.name()]


class Model:
    """Wraps ``network`` (a ``torch.nn.Module`` on its device) for
    training and evaluation."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._step_flops = None  # None = not probed, False = unavailable
        self.stop_training = False

    @property
    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    def _loader(self, data, batch_size, **kw):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, device=self._device,
                          **kw)

    # ------------------------------------------------------------- prepare --
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare(amp_configs=...) is not ported (the "
                "reference accepts it and ignores it, ROADMAP.md §C): run "
                "the network under amp.auto_cast in the loss instead")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = ([metrics] if isinstance(metrics, Metric)
                         else _as_list(metrics))
        if optimizer is not None and loss is not None:
            def loss_fn(model, *batch):
                *xs, y = batch
                return self._loss(model(*xs), y)

            if _fleet_world() > 1:
                self._train_step = self._distributed_step(loss_fn, optimizer)
            else:
                self._train_step = TrainStep(self.network, loss_fn,
                                             optimizer)
        return self

    def _distributed_step(self, loss_fn, optimizer):
        """The reference's distributed branch: the network placed by
        ``fleet.distributed_model``, the optimizer wrapped, the step a
        ``DistTrainStep``."""
        from .distributed import fleet

        placed = fleet.distributed_model(self.network)
        if placed is not self.network:
            # a PipelineParallel wrapper: hapi's step loop cannot drive a
            # pipeline schedule (the reference's restriction)
            raise NotImplementedError(
                "paddle.Model with a PipelineLayer network: use "
                "fleet.distributed_model(...).train_batch directly")
        self._optimizer = fleet.distributed_optimizer(optimizer)
        return fleet.DistTrainStep(self.network, loss_fn, self._optimizer)

    # ---------------------------------------------------------------- steps --
    def train_batch(self, inputs, labels=None, update=True):
        """One optimizer step; returns ``[loss]`` as a float."""
        self.network.train()
        loss = self._train_step(*_as_list(inputs), *_as_list(labels))
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """``([loss] or [], [metric of the batch, ...])``; the metrics
        accumulate."""
        self.network.eval()
        labels = _as_list(labels)
        out = self.network(*_as_list(inputs))
        loss = (self._loss(out, labels[0]) if (self._loss and labels)
                else None)
        metrics = [m.update(m.compute(out, *labels)) for m in self._metrics]
        return ([float(loss)] if loss is not None else []), metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return [_host(self.network(*_as_list(inputs)))]

    def comm_traffic(self, *batch):
        """Collective-traffic report of one train step on ``batch``
        (``distributed/comm_analysis.py``): every collective the step
        issued with its payload and mesh axes, the per-axis wire summary,
        and the gradient exchange by bucket (``grad_exchange``: how many
        buckets it used, what fraction of the f32 bytes the wire dtype
        removed). The port compiles no program to read, so the step RUNS,
        recorded: the parameters and the optimizer take that step.
        Multi-rank only."""
        from .distributed import collective as C
        from .distributed import comm_analysis as _ca

        if self._train_step is None or _fleet_world() <= 1:
            raise RuntimeError(
                "comm_traffic needs prepare(optimizer, loss) and a "
                "multi-device mesh")
        self.network.train()
        with C.record_collectives() as records:
            self._train_step(*batch)
        colls = _ca.collective_traffic(records)
        return {
            "collectives": colls,
            "per_axis": _ca.axis_traffic_summary(colls),
            # wire-dtype split per axis: activation collectives quantized
            # by mp_comm show payload_bytes < payload_bytes_f32 here
            "per_axis_wire": _ca.axis_wire_summary(colls),
            "grad_exchange": _ca.bucket_traffic(colls),
        }

    # ------------------------------------------------------------------ fit --
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, shuffle=shuffle,
                                    drop_last=drop_last,
                                    num_workers=num_workers)
        eval_loader = (None if eval_data is None else
                       self._loader(eval_data, batch_size,
                                    num_workers=num_workers))
        cbks = _cb.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=len(train_loader),
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose,
            metrics=["loss"] + [n for m in self._metrics
                                for n in _metric_names(m)])
        cbks.on_begin("train")
        step_count = 0
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_batch_begin("train", step, logs)
                xs, ys = self._split_batch(batch)
                logs["loss"] = self.train_batch(xs, ys)[0]
                logs["batch_size"] = xs[0].shape[0] if xs else batch_size
                flops = self._probe_step_flops(xs, ys)
                if flops:
                    logs["step_flops"] = flops
                cbks.on_batch_end("train", step, logs)
                step_count += 1
                if num_iters is not None and step_count >= num_iters:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        return self

    def _probe_step_flops(self, xs, ys):
        """FLOPs of one train step (``TrainStep.cost_analysis``), probed
        once after the first batch and only with telemetry on: the MFU
        gauge of ``callbacks.TelemetryLogger``. None when unavailable."""
        if self._step_flops is None and _obs.enabled() \
                and self._train_step is not None:
            try:
                cost = self._train_step.cost_analysis(*xs, *ys)
                self._step_flops = float(cost.get("flops", 0.0)) or False
            except Exception:
                self._step_flops = False
        return self._step_flops or None

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return [batch], []

    def _run_eval(self, loader):
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            loss, _ = self.eval_batch(*self._split_batch(batch))
            losses.extend(loss[:1])
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            logs.update(dict(zip(_metric_names(m), vals)))
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        """``{"loss": mean batch loss, metric name: value, ...}``."""
        return self._run_eval(self._loader(eval_data, batch_size,
                                           num_workers=num_workers))

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """``[list of each batch's output]`` as numpy (the first field of a
        tuple batch is the input), or ``[all batches concatenated]`` with
        ``stack_outputs``."""
        loader = self._loader(test_data, batch_size,
                              num_workers=num_workers)
        outputs = []
        for batch in loader:
            xs = batch[0] if isinstance(batch, (list, tuple)) else batch
            outputs.append(self.predict_batch([xs])[0])
        if stack_outputs:
            return [np.concatenate(outputs)]
        return [outputs]

    # ------------------------------------------------------------- persist --
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, with ``training``
        and an optimizer, ``path.pdopt``, in the reference's format."""
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load what :meth:`save` (or the reference's) wrote at ``path``
        onto the network's device."""
        dev = self._device
        params = path + ".pdparams"
        state = _load(params if os.path.exists(params) else path,
                      device=dev)
        set_state_dict(self.network, state)
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt",
                                                 device=dev))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        """The parameter counts (with ``input_size``, also the per-layer
        table of ``hapi.model_summary.summary``)."""
        if input_size is not None:
            return _summary(self.network, input_size,
                            None if dtype is None else [dtype])
        n_params = sum(p.numel() for p in self.network.parameters())
        trainable = sum(p.numel() for p in self.network.parameters()
                        if p.requires_grad)
        print(f"Total params: {n_params:,}\nTrainable params: {trainable:,}")
        return {"total_params": n_params, "trainable_params": trainable}


__all__ = ["Model"]
