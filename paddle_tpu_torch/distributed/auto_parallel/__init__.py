"""Semi-automatic parallelism: placements, ``shard_tensor`` / ``reshard``,
the sharded data loader and the ``Engine`` (counterpart of
``paddle_tpu/distributed/auto_parallel/__init__.py``).

What the port's tensors are. The reference gives every op global semantics
(GSPMD): a placed array is one global value whatever its layout. Here each
rank computes on local tensors and the collectives are explicit, so:

- At the API edge a placed tensor is a ``torch.distributed.tensor.DTensor``
  on the ``DeviceMesh`` of a :class:`~..mesh.ProcessMesh` (its own groups,
  the fleet topology's where they exist): ``shard_tensor``,
  ``dtensor_from_fn``, ``reshard`` and what ``shard_dataloader`` yields
  return one. Paddle's :class:`Placement` classes are the port's own, with
  the reference's ``__eq__`` / ``__repr__`` (a port ``Shard(0)`` equals
  DTensor's), and convert to DTensor's. Three reference rules differ from
  DTensor's defaults, and the port takes the reference's:

  1. a dim that a mesh axis does not divide stays replicated on that axis
     (the reference's ``_sanitize_spec``; DTensor would cut uneven chunks);
  2. ``shard_tensor(x, mesh, [Partial()])`` keeps ``x``'s value: the rank
     at coordinate 0 of a ``Partial`` axis holds ``x`` and the others zeros,
     so the pending sum is ``x`` (a copy of ``x`` on every rank would sum to
     ``n * x``); ``reshard`` to ``Partial`` raises, as the reference's;
  3. ``numpy()`` of a placed tensor gives its global value (all-gathered:
     a collective, every rank of the mesh calls it), as the reference's.

- The model body never sees a DTensor. The kernels (K1-K4, reached
  through ``nn/functional/attention.py`` and ``ops/``) take plain tensors,
  and a pybind entry handed a DTensor would fail or read the wrapper. So
  ``parallelize``'s plans (``distributed/parallelize.py``) turn a layer's
  parameters into local shards in the form the port's mp layers use
  (``split_axis``, ``mpu.is_mp_shard``, the mp group of the fleet
  topology), and the layer runs through the mp autograd collectives of
  ``fleet/layers/mpu.py``. ``shard_tensor`` of a parameter with a
  ``Shard`` placement raises ``NotImplementedError``: a layer that no plan
  knows cannot compute the reference's result on a split weight. A forward
  pre-hook (``parallelize``, ``to_distributed``, ``shard_layer``) turns a
  DTensor input into this rank's local block (``to_local()``), and so does
  ``jit.TrainStep`` for its batch: a batch split over the data axis runs
  its loss on the rank's rows under the §C.26 rules
  (``nn.functional.loss.split_batch``), and the optimizer that
  ``parallelize`` / ``to_distributed`` return averages the gradients over
  the data axis.

``Engine`` drives ``fleet.DistTrainStep`` (plain ``TrainStep`` without a
fleet topology), with ``auto_cast`` under ``strategy.amp`` and the
reference's warnings for ``recompute`` / ``gradient_merge``; its
``save`` / ``load`` write and read ``.pdparams`` / ``.pdopt`` holding the
full arrays (``io_state.gather_full_state`` /
``gather_full_optimizer_state`` on a split model), as the reference's
global arrays are.

The layout planner is ``auto_parallel/planner.py`` (``plan``,
``apply_auto_plan`` behind ``DistributedStrategy.auto()``,
``plan_mpmd_stages``, ``plan_attn_kernel``), its costs fitted to
``calibration_h100.json``, weak-scaling entries measured on the card.
"""
from __future__ import annotations

import functools
import sys
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import mesh as _mesh
from ..mesh import ProcessMesh, _sanitize_spec


class Placement:
    pass


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        from torch.distributed.tensor import Replicate as _R

        return isinstance(o, (Replicate, _R))

    def __hash__(self):
        return hash("Replicate")


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        from torch.distributed.tensor import Shard as _S

        return isinstance(o, (Shard, _S)) and o.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Partial(Placement):
    """A pending sum over the mesh axis (see the module docstring, rule
    2)."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def __repr__(self):
        return f"Partial({self.reduce_type})"


def _is(p, name):
    return type(p).__name__ == name


def placements_to_spec(mesh: ProcessMesh, placements, ndim: int):
    """The reference's spec of ``placements`` (one a mesh axis): a tuple of
    axis names (or a tuple of names, mesh-axis order, or None) a dim;
    ``Partial`` and ``Replicate`` name nothing."""
    entries: List = [None] * ndim
    for axis_idx, pl in enumerate(placements):
        if _is(pl, "Shard"):
            name = mesh.dim_names[axis_idx]
            d = pl.dim % ndim
            if entries[d] is None:
                entries[d] = name
            elif isinstance(entries[d], tuple):
                entries[d] = entries[d] + (name,)
            else:
                entries[d] = (entries[d], name)
    return tuple(entries)


def spec_to_placements(mesh: ProcessMesh, spec) -> List[Placement]:
    """One port placement a mesh axis from a spec (its axes in mesh order
    within a dim)."""
    from ..reshard import _norm_spec

    out: List[Placement] = [Replicate() for _ in mesh.dim_names]
    for d, axes in enumerate(_norm_spec(spec, len(spec))):
        for a in axes:
            out[mesh.dim_names.index(a)] = Shard(d)
    return out


def _global(t):
    """The global value of a placed DTensor on every rank of its mesh (a
    collective): its Partial axes summed, its split axes gathered."""
    from .. import collective
    from ..reshard import _norm_spec, _regather

    mesh = t.process_mesh
    local = t.to_local().detach()
    partial = [i for i, p in enumerate(t.placements) if p.is_partial()]
    if partial:
        local = local.clone()
        for i in partial:
            collective.all_reduce(local, group=mesh.get_group(i))
    spec = placements_to_spec(mesh, t.placements, t.dim())
    return _regather(local, _norm_spec(spec, t.dim()), ((),) * t.dim(), mesh,
                     "numpy")


def _numpy(t):
    return _global(t).cpu().numpy()


def _place(local, mesh: ProcessMesh, spec, shape, partial=()):
    """A DTensor over ``local`` (this rank's block under ``spec``), with
    ``Partial`` on the mesh axes ``partial``; it carries ``process_mesh``
    and the reference's ``numpy()``."""
    from torch.distributed import tensor as dt

    from ..reshard import _norm_spec

    placements = [dt.Replicate() for _ in mesh.dim_names]
    for d, axes in enumerate(_norm_spec(spec, len(shape))):
        idx = [mesh.dim_names.index(a) for a in axes]
        if idx != sorted(idx):  # DTensor splits a dim in mesh-axis order
            raise NotImplementedError(
                f"a DTensor splits a dim by mesh axes in mesh order; {spec} "
                "is not, see ROADMAP.md §A.7 item 4")
        for i in idx:
            placements[i] = dt.Shard(d)
    for i in partial:
        placements[i] = dt.Partial("sum")
    shape = torch.Size(shape)
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    out = dt.DTensor.from_local(local, mesh.device_mesh(), placements,
                                run_check=False, shape=shape,
                                stride=tuple(stride))
    out.process_mesh = mesh
    out.numpy = functools.partial(_numpy, out)
    return out


def _as_tensor(data, dtype=None):
    from ...tensor.creation import to_tensor

    if isinstance(data, torch.Tensor) and not _is_dtensor(data):
        return data if dtype is None else data.to(dtype)
    if _is_dtensor(data):
        return _global(data)
    return to_tensor(data, dtype=dtype)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient=None, **kwargs):
    """``data`` (a tensor, an array, a DTensor) placed on ``mesh`` by
    ``placements`` (one a mesh axis): a DTensor whose local block is this
    rank's part (rules 1 and 2 of the module docstring). A parameter with
    a ``Shard`` placement raises: only a ``parallelize`` plan splits a
    layer's weights."""
    if isinstance(data, torch.nn.Parameter) and any(
            _is(p, "Shard") for p in placements):
        raise NotImplementedError(
            "shard_tensor(Shard) of a layer's parameter: the port's layers "
            "compute on local tensors, so only a parallelize plan "
            "(ColWiseParallel / RowWiseParallel) splits a weight; see "
            "ROADMAP.md §A.7 item 4")
    if len(placements) != mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a mesh of "
                         f"{mesh.ndim} axes")
    from ...framework.dtype import convert_dtype
    from ..reshard import local_block

    value = _as_tensor(data, convert_dtype(dtype))
    spec = _sanitize_spec(placements_to_spec(mesh, placements, value.dim()),
                          tuple(value.shape), mesh)
    local = local_block(value.detach(), mesh, spec).clone()
    partial = [i for i, p in enumerate(placements) if _is(p, "Partial")]
    if any(mesh.axis_coord(mesh.dim_names[i]) != 0 for i in partial):
        local.zero_()
    if stop_gradient is None:
        stop_gradient = not getattr(data, "requires_grad", False)
    if not stop_gradient and local.is_floating_point():
        local.requires_grad_(True)
    return _place(local, mesh, spec, tuple(value.shape), partial)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    """``shard_tensor(fn(*args, **kwargs), mesh, placements)``."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(tensor, mesh: ProcessMesh, placements: Sequence[Placement]):
    """``tensor`` moved to ``placements`` on ``mesh`` by the planned
    slice / all-to-all / all-gather steps (``distributed/reshard.py``);
    a plain tensor is taken as the global value. To ``Partial`` raises."""
    if any(_is(p, "Partial") for p in placements):
        raise NotImplementedError("reshard to Partial is not supported")
    from .. import collective
    from ..reshard import local_block, reshard_array

    if not _is_dtensor(tensor):
        return shard_tensor(tensor, mesh, placements)
    spec = _sanitize_spec(placements_to_spec(mesh, placements, tensor.dim()),
                          tuple(tensor.shape), mesh)
    partial = [i for i, p in enumerate(tensor.placements) if p.is_partial()]
    if partial:  # the pending sum first: the value is then replicated there
        local = tensor.to_local().detach().clone()
        for i in partial:
            collective.all_reduce(local, group=tensor.process_mesh.get_group(
                i))
        src = tensor.process_mesh
        tensor = _place(local, src, placements_to_spec(
            src, tensor.placements, tensor.dim()), tuple(tensor.shape))
    out, _ = reshard_array(tensor, mesh, spec)
    return out


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Apply ``shard_fn(name, sublayer, mesh)`` over the sublayers (the
    reference's; ``input_fn`` / ``output_fn`` are taken and not applied,
    as there), and turn DTensor inputs into local tensors."""
    if shard_fn is not None:
        for name, sub in layer.named_sublayers(include_self=True):
            shard_fn(name, sub, process_mesh)
    install_local_inputs(layer)
    return layer


def get_mesh() -> Optional[ProcessMesh]:
    return _mesh.get_global_mesh()


def set_mesh(mesh: ProcessMesh):
    _mesh.set_global_mesh(mesh)


# ------------------------------------------------------- DTensor inputs
def _data_group(t):
    """The group over which the batch rows of a DTensor input are split
    (its dim 0 by one mesh axis), or None when they are not."""
    mesh = t.process_mesh
    axes = [mesh.dim_names[i] for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim == 0]
    if not axes:
        return None
    if len(axes) > 1 or axes[0] not in ("dp", "sharding"):
        raise NotImplementedError(
            f"a batch split over mesh axes {axes}: the port averages "
            "gradients over the data axis ('dp' or 'sharding') only, see "
            "ROADMAP.md §A.7 item 4")
    return mesh.get_group(axes[0])


def local_inputs(args, kwargs=None, data_group=True):
    """``(args, kwargs, group)``: every DTensor among them replaced by this
    rank's local block, and (``data_group``) the group over which their
    batch rows are split (None when none is)."""
    group = None

    def conv(v):
        nonlocal group
        if not _is_dtensor(v):
            return v
        if any(p.is_partial() for p in v.placements):
            raise NotImplementedError(
                "a Partial DTensor as an input; reshard it first")
        g = _data_group(v) if data_group else None
        group = g if g is not None else group
        return v.to_local()

    args = tuple(conv(a) for a in args)
    kwargs = {k: conv(v) for k, v in (kwargs or {}).items()}
    return args, kwargs, (group if group is not None and group.nranks > 1
                          else None)


def _localize(module, args, kwargs):
    args, kwargs, _ = local_inputs(args, kwargs, data_group=False)
    return args, kwargs


def install_local_inputs(layer):
    """A forward pre-hook on ``layer`` turning DTensor inputs into this
    rank's local blocks (once a layer)."""
    if not getattr(layer, "_local_inputs_hook", False):
        layer.register_forward_pre_hook(_localize, with_kwargs=True)
        layer._local_inputs_hook = True
    return layer


# ------------------------------------------------------- sharded loader
class _ShardDataLoader:
    """Iterable that places every batch on the mesh as it is yielded."""

    def __init__(self, dataloader, mesh, shard_dim, input_keys):
        self._dl = dataloader
        self._mesh = mesh
        self._dim = shard_dim  # mesh axis NAME or None
        self._keys = set(input_keys) if input_keys else None

    def __len__(self):
        return len(self._dl)

    def _place(self, item, shard):
        if isinstance(item, (list, tuple)):
            return type(item)(self._place(x, shard) for x in item)
        if isinstance(item, dict):
            return {
                k: self._place(
                    v, shard and (self._keys is None or k in self._keys))
                for k, v in item.items()
            }
        if not hasattr(item, "shape"):
            return item
        # one placement per MESH axis; Shard(0) = split the batch (tensor
        # dim 0) along the axis named by shard_dims
        placements = [Replicate()] * self._mesh.ndim
        if shard and self._dim is not None and len(item.shape):
            placements[self._mesh.dim_names.index(self._dim)] = Shard(0)
        return shard_tensor(item, self._mesh, placements)

    def __iter__(self):
        for batch in self._dl:
            yield self._place(batch, True)


def shard_dataloader(dataloader, meshes, shard_dims=None, input_keys=None):
    """paddle.distributed.shard_dataloader: each yielded batch placed on
    ``meshes`` (a list collapses to its first mesh), its dim 0 split
    along ``shard_dims`` (a mesh axis name or index, or a list of them,
    one a mesh), or replicated when None; ``input_keys`` restricts the
    split to those keys of a dict batch. Every rank iterates the same
    loader: its local block is its rows of the global batch."""
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
    if isinstance(shard_dims, (list, tuple)):
        shard_dims = shard_dims[0] if len(shard_dims) else None
    if isinstance(shard_dims, (int, np.integer)):
        try:
            shard_dims = mesh.dim_names[int(shard_dims)]
        except IndexError:
            raise ValueError(
                f"shard_dims index {shard_dims} out of range for mesh axes "
                f"{mesh.dim_names}") from None
    if shard_dims is not None:
        names = tuple(getattr(mesh, "dim_names", ()) or ())
        if names and shard_dims not in names:
            raise ValueError(
                f"shard_dims {shard_dims!r} is not a mesh axis of {names}")
    return _ShardDataLoader(dataloader, mesh, shard_dims, input_keys)


# ------------------------------------------------------------- Engine
class Strategy:
    """auto_parallel Strategy: ``amp`` is applied by the Engine
    (``auto_cast`` around the loss); ``recompute`` / ``gradient_merge`` are
    taken and warned about when enabled; ``sharding`` / ``pipeline`` belong
    to the fleet topology."""

    class _Section(dict):
        __getattr__ = dict.get

        def __setattr__(self, k, v):
            self[k] = v

    def __init__(self):
        self.auto_mode = "semi"
        self.amp = self._Section(enable=False, dtype="bfloat16")
        self.recompute = self._Section(enable=False)
        self.sharding = self._Section(enable=False, degree=1, stage=1)
        self.gradient_merge = self._Section(enable=False, k_steps=1)
        self.pipeline = self._Section(enable=False, schedule_mode="1F1B")


def _split_model() -> bool:
    from ..fleet.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg is not None and hcg.nranks > 1


class Engine:
    """auto_parallel.Engine: fit / evaluate / predict of a model, a loss and
    an optimizer over a dataset (see the module docstring)."""

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 strategy=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics or []
        self._strategy = strategy or Strategy()
        self._step = None

    def _get_step(self):
        if self._step is None:
            from ...jit import TrainStep
            from ..fleet.topology import get_hybrid_communicate_group

            loss_fn = self._loss
            strat = self._strategy
            for knob in ("recompute", "gradient_merge"):
                if getattr(strat, knob, None) and getattr(strat, knob).get(
                        "enable"):
                    warnings.warn(
                        f"auto_parallel Strategy.{knob} is not applied by "
                        "this Engine (use fleet recompute_helper / manual "
                        "grad accumulation); continuing without it")
            amp_on = bool(strat.amp.get("enable"))
            amp_dtype = strat.amp.get("dtype") or "bfloat16"

            def compute_loss(model, *batch):
                *xs, y = batch
                if amp_on:
                    from ... import amp as _amp

                    with _amp.auto_cast(enable=True, dtype=amp_dtype):
                        return loss_fn(model(*xs), y)
                return loss_fn(model(*xs), y)

            if get_hybrid_communicate_group() is not None:
                from ..fleet import DistTrainStep

                self._step = DistTrainStep(self._model, compute_loss,
                                           self._optimizer)
            else:
                self._step = TrainStep(self._model, compute_loss,
                                       self._optimizer)
        return self._step

    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None,
            log_freq=10, verbose=1, **kwargs):
        history = {"loss": []}
        step_fn = self._get_step()
        if epochs > 1 and iter(train_data) is iter(train_data):
            # one-shot iterator: materialize so epochs 2..N see data
            train_data = list(train_data)
        for epoch in range(epochs):
            for i, batch in enumerate(_iter_batches(train_data, batch_size)):
                loss = step_fn(*batch)
                history["loss"].append(float(loss))
                if verbose and i % log_freq == 0:
                    print(f"[Engine] epoch {epoch} step {i} loss "
                          f"{history['loss'][-1]:.5f}", file=sys.stderr)
                if steps_per_epoch is not None and i + 1 >= steps_per_epoch:
                    break
        return history

    def evaluate(self, valid_data, batch_size=None, steps=None, **kwargs):
        was_training = self._model.training
        self._model.eval()
        losses = []
        try:
            with torch.no_grad():
                for i, batch in enumerate(_iter_batches(valid_data,
                                                        batch_size)):
                    *xs, y = batch
                    losses.append(float(self._loss(self._model(*xs), y)))
                    if steps is not None and i + 1 >= steps:
                        break
        finally:
            if was_training:
                self._model.train()
        return {"loss": float(np.mean(losses)) if losses else None}

    def predict(self, test_data, batch_size=None, steps=None, **kwargs):
        was_training = self._model.training
        self._model.eval()
        outs = []
        try:
            with torch.no_grad():
                for i, batch in enumerate(_iter_batches(test_data,
                                                        batch_size)):
                    xs = batch if isinstance(batch, (list, tuple)) \
                        else (batch,)
                    outs.append(self._model(*xs))
                    if steps is not None and i + 1 >= steps:
                        break
        finally:
            if was_training:
                self._model.train()
        return outs

    def save(self, path, training=True):
        """``path.pdparams`` (and ``path.pdopt``) with the full arrays; on a
        split model every rank gathers (a collective) and the first
        writes."""
        from ...framework import io_state
        from .. import collective
        from ..env import get_rank

        split = _split_model()
        params = (io_state.gather_full_state(self._model) if split
                  else self._model.state_dict())
        opt = None
        if training and self._optimizer is not None:
            opt = (io_state.gather_full_optimizer_state(self._optimizer)
                   if split else self._optimizer.state_dict())
        if get_rank() == 0:
            io_state.save(params, path + ".pdparams")
            if opt is not None:
                io_state.save(opt, path + ".pdopt")
        if split:
            collective.barrier()

    def load(self, path, strict=True, load_optimizer=True):
        import os

        from ...framework import io_state

        split = _split_model()
        state = io_state.load(path + ".pdparams", return_numpy=True)
        if split:
            io_state.load_numpy_state(self._model, state)
        else:
            io_state.set_state_dict(self._model, state)
        if load_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            dev = next(self._model.parameters()).device
            opt = io_state.load(path + ".pdopt", device=dev)
            if split:
                io_state.load_full_optimizer_state(self._optimizer, opt)
            else:
                self._optimizer.set_state_dict(opt)


def _iter_batches(data, batch_size):
    """A DataLoader-like iterable, a list of batch tuples, or an ``(x, y)``
    pair of whole arrays (cut into ``batch_size`` rows); placed batches
    are taken as their global values (``DistTrainStep`` splits them)."""
    def glob(batch):
        if isinstance(batch, (list, tuple)):
            return type(batch)(glob(v) for v in batch)
        return _global(batch) if _is_dtensor(batch) else batch

    if hasattr(data, "__iter__") and not isinstance(data, (tuple, list)):
        for batch in data:
            yield glob(batch)
        return
    if isinstance(data, (tuple, list)):
        if data and isinstance(data[0], (tuple, list)):
            yield from (glob(b) for b in data)
            return
        xs = [_as_tensor(d) for d in data]
        n = xs[0].shape[0]
        bs = batch_size or n
        for i in range(0, n, bs):
            yield tuple(x[i:i + bs] for x in xs)


__all__ = ["Engine", "Partial", "Placement", "ProcessMesh", "Replicate",
           "Shard", "Strategy", "dtensor_from_fn", "get_mesh", "reshard",
           "set_mesh", "shard_dataloader", "shard_layer", "shard_tensor"]
