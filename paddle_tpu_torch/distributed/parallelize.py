"""paddle.distributed.parallelize / to_distributed (counterpart of
``paddle_tpu/distributed/parallelize.py``).

The reference's plans only re-place parameters: GSPMD then runs the
model's global program over the placed arrays. The port has no GSPMD, so a
plan makes its layer compute that global result on local shards, with the
mp autograd collectives of ``fleet/layers/mpu.py`` over the model-parallel
group of a fleet topology laid over the mesh (made by ``parallelize`` when
none matches it; the mesh's axes map onto ``(dp, pp, sharding, sep, mp)``):

- :class:`ColWiseParallel` keeps this rank's columns of a ``Linear``'s
  weight ``[in, out]`` (``split_axis`` 1) and of its bias when the degree
  divides it (else the bias stays whole), or of an ``Embedding``'s
  embedding dim. Its input passes through ``_c_identity`` (identity
  forward, all-reduce backward); the output stays split unless
  ``gather_output``. A split output is only right where the next layer
  reads this rank's block: a ``RowWiseParallel`` layer with
  ``is_input_parallel``, elementwise ops in between, or the per-head
  blocks of an attention: a plan on GPT's fused ``qkv_proj`` (head-major
  ``[H, 3, d]`` columns, so a contiguous split keeps heads whole) or on
  Llama's ``q_proj`` / ``k_proj`` / ``v_proj`` sets the attention's local
  head counts, as the fleet mp construction does, and raises
  ``NotImplementedError`` where the degree would cut a head. A model whose
  output is a split ColWise output raises too.
- :class:`RowWiseParallel` keeps this rank's rows of a ``Linear``'s weight
  (``split_axis`` 0): the input is split first unless
  ``is_input_parallel``, the output all-reduced, then the (whole) bias
  added. On an ``Embedding`` it is the vocab-parallel lookup (ids outside
  the rank's rows look up 0, the ranks' rows all-reduced).
- :class:`SequenceParallelBegin` on a ColWise layer takes its input through
  the sequence scatter / all-gather of ``sequence_parallel_utils`` (dim 1,
  over mp; the backward is the all-reduce ``_c_identity`` gives);
  :class:`SequenceParallelEnd` on a RowWise layer reduce-scatters the
  output along the sequence, adds the bias on its part (a sequence-parallel
  parameter, its gradient summed over mp) and all-gathers it back. Elsewhere
  they raise: alone they would change the gradient.

``parallelize`` returns the model and the optimizer wrapped in a
``HybridParallelOptimizer`` (the clip, Lamb and Lars sum a split
parameter's squares over its group) whose ``step`` first averages the
gradients over the data axes (``hybrid_parallel_util.allreduce_gradients``,
ZeRO-3 slices and the sequence-parallel sums included), as
``DistTrainStep`` does: a user's plain ``TrainStep`` takes its gradients by
``torch.autograd.grad``, under which ``DataParallel``'s accumulation hooks
never fire. With the batch replicated that mean changes nothing; with a
batch split by ``shard_dataloader`` it is the data-parallel mean, and the
loss runs under the §C.26 rules (``auto_parallel`` module docstring).
``dp_config.sharding_level`` 1-2 shard the update by owner over the mesh's
``sharding`` axis, 3 cuts the parameters to slices
(``meta_parallel/sharding_stage3.py``). ``pp_config`` raises, as the
reference's does; so do a mesh with a ``pp`` or ``sep`` axis above 1 (the
model body is not pipelined or sequence-split here) and a mesh whose ranks
are not the grid ``0 .. n - 1`` in order.

``to_distributed`` lays a 1-D ``dp`` mesh over the world, keeps the
parameters replicated (broadcast from the first rank), and wraps the data
loader to split each batch over ``dp``.
"""
from __future__ import annotations

import fnmatch
import threading
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..nn.functional import common as F
from ..nn.layer import Layer
from . import grad_comm
from .fleet import HybridParallelOptimizer
from .fleet.layers import mpu
from .fleet.utils import hybrid_parallel_util as _hpu
from .fleet.utils import sequence_parallel_utils as _spu

__all__ = [
    "ColWiseParallel", "RowWiseParallel", "SequenceParallelBegin",
    "SequenceParallelEnd", "parallelize", "to_distributed",
]

_ITEM = "ROADMAP.md §A.7 item 4"
_tls = threading.local()


def _kind(layer) -> str:
    """``"linear"`` (a weight ``[in, out]``, optional bias) or
    ``"embedding"`` (a table ``[vocab, dim]``)."""
    from ..nn.layers.common import Embedding, Linear

    if isinstance(layer, (Embedding, mpu.VocabParallelEmbedding)):
        return "embedding"
    if isinstance(layer, (Linear, mpu.ColumnParallelLinear,
                          mpu.RowParallelLinear)):
        return "linear"
    raise NotImplementedError(
        f"a parallelize plan on {type(layer).__name__}: the port splits the "
        f"weights of Linear and Embedding layers only, see {_ITEM}")


def _split(p, axis, group):
    """Cut parameter ``p`` in place to this rank's part along ``axis``."""
    with torch.no_grad():
        p.data = mpu.shard_of(p.data, axis, group.rank, group.nranks).clone(
            memory_format=torch.contiguous_format)
    p.is_distributed = True
    p.split_axis = axis
    p.__dict__["_ap_split"] = True


def _check_whole(layer):
    if getattr(layer, "world_size", 1) > 1 or hasattr(layer, "_ap_plan"):
        raise ValueError(
            f"parallelize: {type(layer).__name__} is split already (built "
            "at mp > 1, or given a plan before)")


_classes: Dict = {}


def _plan_class(cls, forward):
    """``cls`` with ``forward`` (one class a pair, reused)."""
    key = (cls, forward)
    if key not in _classes:
        _classes[key] = type(cls.__name__, (cls,), {"forward": forward,
                                                    "_ap_base": cls})
    return _classes[key]


def _swap_forward(layer, forward):
    base = type(layer).__dict__.get("_ap_base", type(layer))
    layer.__class__ = _plan_class(base, forward)


class _PlanBase:
    def apply(self, layer: Layer, mesh, axis: str):
        raise NotImplementedError


def _col_input(layer, args):
    x, *rest = args
    group = layer._ap_group
    if getattr(layer, "_ap_sp_begin", False):
        x = _spu.AllGatherOp.apply(_spu.ScatterOp.apply(x, 1, group), 1,
                                   group)
    elif x.is_floating_point():
        x = mpu._c_identity(x, group)
    return (x, *rest)


def _col_output(layer, args, out):
    if layer._ap_gather:
        return mpu._c_concat(out, layer._ap_group)
    _split_outputs().append(weakref.ref(out))
    return out


def _split_outputs():
    """Weak references to the split ColWise outputs of the running
    forward."""
    s = getattr(_tls, "split", None)
    if s is None:
        s = _tls.split = []
    return s


class ColWiseParallel(_PlanBase):
    """Column-parallel: this rank's columns of the weight (output dim) and
    of the bias; for an Embedding, of the embedding dim (see the module
    docstring)."""

    def __init__(self, gather_output: bool = False):
        self.gather_output = gather_output

    def apply(self, layer, mesh, axis):
        _kind(layer)
        _check_whole(layer)
        group = mesh.get_group(axis)
        _split(layer.weight, 1, group)
        bias = getattr(layer, "bias", None)
        if bias is not None and bias.shape[0] % group.nranks == 0:
            _split(bias, 0, group)
        layer._ap_plan = "col"
        layer._ap_group = group
        layer._ap_gather = self.gather_output
        layer.register_forward_pre_hook(_col_input)
        layer.register_forward_hook(_col_output)


def _row_linear_forward(self, x):
    group = self._ap_group
    if not self._ap_input_parallel:
        x = mpu._c_split(x, group)
    y = F.linear(x, self.weight)
    if getattr(self, "_ap_sp_end", False):
        y = _spu.ReduceScatterOp.apply(y, 1, group)
        if self.bias is not None:
            y = y + self.bias
        return _spu.GatherOp.apply(y, 1, group)
    y = mpu._mp_allreduce(y, group)
    return y if self.bias is None else y + self.bias


def _row_embedding_forward(self, ids):
    group = self._ap_group
    rows = self.weight.shape[0]
    local = ids - group.rank * rows
    outside = (local < 0) | (local >= rows)
    out = F.embedding(torch.where(outside, 0, local), self.weight)
    pad = getattr(self, "_padding_idx", None)
    if pad is not None:
        outside = outside | (ids == pad)
    out = out.masked_fill(outside.unsqueeze(-1), 0.0)
    return mpu._mp_allreduce(out, group)


class RowWiseParallel(_PlanBase):
    """Row-parallel: this rank's rows of the weight (input dim), the bias
    whole, added after the all-reduce; for an Embedding the vocab-parallel
    lookup (see the module docstring)."""

    def __init__(self, is_input_parallel: bool = True):
        self.is_input_parallel = is_input_parallel

    def apply(self, layer, mesh, axis):
        kind = _kind(layer)
        _check_whole(layer)
        group = mesh.get_group(axis)
        _split(layer.weight, 0, group)
        layer._ap_plan = "row"
        layer._ap_group = group
        layer._ap_input_parallel = self.is_input_parallel
        _swap_forward(layer, _row_linear_forward if kind == "linear"
                      else _row_embedding_forward)


class _SeqParallelMarker(_PlanBase):
    _flag = ""
    _needs = ""

    def apply(self, layer, mesh, axis):
        setattr(layer, self._flag, True)


class SequenceParallelBegin(_SeqParallelMarker):
    """The sequence split starts at this ColWise layer's input."""

    _flag, _needs = "_ap_sp_begin", "col"


class SequenceParallelEnd(_SeqParallelMarker):
    """The sequence split ends at this RowWise layer's output."""

    _flag, _needs = "_ap_sp_end", "row"


def _check_markers(layer):
    for marker in (SequenceParallelBegin, SequenceParallelEnd):
        if getattr(layer, marker._flag, False) and \
                getattr(layer, "_ap_plan", None) != marker._needs:
            plan = ("ColWiseParallel" if marker._needs == "col"
                    else "RowWiseParallel")
            raise NotImplementedError(
                f"{marker.__name__} on a layer without a {plan} plan: the "
                "port runs the sequence split inside the mp layer's "
                f"collectives only, see {_ITEM}")
    if getattr(layer, "_ap_sp_end", False) and layer.bias is not None:
        layer.bias.sequence_parallel = True


def _match_layers(model: Layer, pattern: str):
    """fnmatch over sublayer names (the reference's dotted-name patterns,
    e.g. ``gpt.decoder.*.attn.qkv_proj``)."""
    hits = []
    for name, sub in model.named_sublayers():
        if fnmatch.fnmatchcase(name, pattern):
            hits.append((name, sub))
    if not hits and pattern in ("", "."):
        hits.append(("", model))
    return hits


def _set_local_heads(model, mp):
    """An attention whose head projections a ColWise plan split (output kept
    split) runs its local heads; a degree that cuts a head raises."""
    from ..text.models.gpt import GPTAttention
    from ..text.models.llama import LlamaAttention

    def split(lin):
        return getattr(lin, "_ap_plan", None) == "col" and not lin._ap_gather

    for name, sub in model.named_sublayers():
        if isinstance(sub, GPTAttention) and split(sub.qkv_proj):
            if sub.num_heads % mp:
                raise NotImplementedError(
                    f"{name}: a column split of qkv_proj over mp {mp} cuts "
                    f"one of its {sub.num_heads} heads, see {_ITEM}")
            sub.num_heads //= mp
        elif isinstance(sub, LlamaAttention) and any(
                split(getattr(sub, p)) for p in ("q_proj", "k_proj",
                                                 "v_proj")):
            if not all(split(getattr(sub, p)) for p in ("q_proj", "k_proj",
                                                        "v_proj")):
                raise NotImplementedError(
                    f"{name}: q_proj, k_proj and v_proj split together or "
                    f"not at all, see {_ITEM}")
            if sub.num_heads % mp or sub.num_kv_heads % mp:
                raise NotImplementedError(
                    f"{name}: a column split over mp {mp} cuts one of its "
                    f"{sub.num_heads} heads / {sub.num_kv_heads} kv heads, "
                    f"see {_ITEM}")
            sub.num_heads //= mp
            sub.num_kv_heads //= mp


def _root_pre(module, args):
    _split_outputs().clear()


def _root_post(module, args, out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if any(r() is o for r in _split_outputs() for o in outs):
        raise NotImplementedError(
            "the model's output is a ColWiseParallel layer's split output: "
            f"give that plan gather_output=True, see {_ITEM}")


_AXIS_OF = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
            "mp": "model"}
_ORDER = ("data", "pipe", "sharding", "sep", "model")


def _topology_for(mesh, mp_axis):
    """The fleet topology over ``mesh`` (made and set unless the one in
    force has the same degrees); returns the hybrid group."""
    from .fleet import topology as topo
    from .env import get_world_size

    names = [_AXIS_OF.get(n, "model" if n == mp_axis else n)
             for n in mesh.dim_names]
    if any(n not in _ORDER for n in names):
        raise NotImplementedError(
            f"mesh axes {mesh.dim_names}: the port maps a mesh onto the "
            f"hybrid axes (dp, pp, sharding, sep, mp), see {_ITEM}")
    if [n for n in _ORDER if n in names] != names or \
            mesh.process_ids != list(range(get_world_size())):
        raise NotImplementedError(
            f"mesh {mesh} with ranks {mesh.process_ids}: the port lays a "
            "mesh out as the fleet topology does (axes in the order dp, pp, "
            "sharding, sep, mp over the ranks 0 .. n - 1), see " + _ITEM)
    dims = [mesh.shape[names.index(n)] if n in names else 1 for n in _ORDER]
    if dims[1] > 1 or dims[3] > 1:
        raise NotImplementedError(
            f"parallelize on a mesh with a pp or sep axis above 1 "
            f"({dict(zip(_ORDER, dims))}): the model body is neither "
            f"pipelined nor sequence-split here, see {_ITEM}")
    hcg = topo.get_hybrid_communicate_group()
    if hcg is None or [hcg._dim(n) for n in _ORDER] != dims:
        hcg = topo.HybridCommunicateGroup(topo.CommunicateTopology(
            _ORDER, dims))
        topo.set_hybrid_communicate_group(hcg)
    return hcg


def _wrap_optimizer(optimizer, hcg, level=0):
    if optimizer is None:
        return None
    from .fleet.strategy import DistributedStrategy

    if isinstance(optimizer, _AutoParallelOptimizer):
        optimizer = optimizer._inner_opt
    if any(st is not None for st in optimizer._accumulators):
        raise ValueError("parallelize / to_distributed: wrap an optimizer "
                         "before its first step")
    s = DistributedStrategy()
    s.sharding_configs["stage"] = max(int(level), 1)
    return _AutoParallelOptimizer(optimizer, hcg, s)


def parallelize(model: Layer, optimizer=None, mesh=None,
                config: Optional[Dict] = None):
    """Apply a parallelization config to ``model`` in one call (see the
    module docstring). ``config`` keys, the reference's:

    - ``mp_config = {"parallelize_plan": {name_pattern: plan | [plans]}}``;
    - ``dp_config = {"sharding_level": 0|1|2|3}``;
    - ``pp_config`` raises ``NotImplementedError``.

    Returns ``(model, optimizer)``."""
    from . import mesh as _mesh_mod
    from .fleet.meta_parallel import sharding_stage3 as _z3
    from .mesh import ProcessMesh

    config = config or {}
    if config.get("pp_config"):
        raise NotImplementedError(
            "parallelize(pp_config=...): pipeline stages are built with "
            "fleet.meta_parallel.SpmdPipeline")
    if mesh is None:
        mesh = _mesh_mod.get_global_mesh()
        if mesh is None:
            raise ValueError("parallelize: pass a ProcessMesh (or fleet.init "
                             "a global mesh) first")
    elif not isinstance(mesh, ProcessMesh):
        raise TypeError(f"parallelize: mesh must be a ProcessMesh, got "
                        f"{type(mesh).__name__}")
    sizes = mesh.axis_sizes
    mp_axis = "mp" if "mp" in sizes else next(
        (a for a in mesh.dim_names if a not in ("dp", "sharding", "pp",
                                                "sep")), None)

    plan = (config.get("mp_config") or {}).get("parallelize_plan") or {}
    if plan and (mp_axis is None or sizes.get(mp_axis, 1) <= 1):
        raise ValueError(
            f"parallelize: mp_config given but mesh {sizes} has no "
            "model-parallel axis ('mp') larger than 1")
    level = int((config.get("dp_config") or {}).get("sharding_level", 0))
    if level and sizes.get("sharding", 1) <= 1:
        raise ValueError(
            "parallelize: dp_config.sharding_level set but the mesh has "
            "no 'sharding' axis larger than 1")
    hcg = _topology_for(mesh, mp_axis)
    hits = []
    for pattern, plans in plan.items():
        plans = plans if isinstance(plans, (list, tuple)) else [plans]
        found = _match_layers(model, pattern)
        if not found:
            raise ValueError(
                f"parallelize: pattern {pattern!r} matched no sublayer")
        for _name, sub in found:
            for pl in plans:
                pl.apply(sub, mesh, mp_axis)
            hits.append(sub)
    for sub in hits:
        _check_markers(sub)
    if plan:
        # an mp layer built whole marks its weight's split dim; only what a
        # plan split is split (the clip, the checkpoint read the mark)
        for p in model.parameters():
            if mpu.is_mp_shard(p) and not p.__dict__.get("_ap_split"):
                p.is_distributed = False
        _set_local_heads(model, sizes[mp_axis])
        if not getattr(model, "_ap_root", False):
            model.register_forward_pre_hook(_root_pre)
            model.register_forward_hook(_root_post)
            model._ap_root = True
    if level == 3:
        _z3.shard_parameters(model, hcg.get_sharding_parallel_group())
    from .auto_parallel import install_local_inputs

    install_local_inputs(model)
    return model, _wrap_optimizer(optimizer, hcg, level)


def to_distributed(model: Layer, optimizer=None, dataloader=None,
                   device_num: Optional[int] = None, node_num: int = 1,
                   config=None):
    """paddle.distributed.to_distributed: data parallel over the world (a
    1-D ``dp`` mesh), the parameters replicated, the loader splitting each
    batch over ``dp``. Returns ``(model, optimizer, dataloader)``."""
    from . import mesh as _mesh_mod
    from .auto_parallel import install_local_inputs, shard_dataloader
    from .env import get_world_size, init_parallel_env
    from .mesh import ProcessMesh

    init_parallel_env()
    world = get_world_size()
    total = min((device_num or world) * max(int(node_num), 1), world)
    if total != world:
        raise NotImplementedError(
            f"to_distributed over {total} of {world} ranks: the port's data "
            f"axis spans the world, see {_ITEM}")
    pm = ProcessMesh(np.arange(total), dim_names=["dp"])
    hcg = _topology_for(pm, None)
    _mesh_mod.set_global_mesh(pm)
    _hpu.broadcast_dp_parameters(model, hcg)
    install_local_inputs(model)
    if dataloader is not None:
        dataloader = shard_dataloader(dataloader, pm, shard_dims="dp")
    return model, _wrap_optimizer(optimizer, hcg), dataloader


class _AutoParallelOptimizer(HybridParallelOptimizer):
    """``HybridParallelOptimizer`` whose ``step`` first averages the
    gradients over the data axes (``DistTrainStep``'s exchange, see the
    module docstring)."""

    def __init__(self, optimizer, hcg, strategy):
        super().__init__(optimizer, hcg, strategy)
        self._bucket_mb = grad_comm.resolve_config(strategy).bucket_mb

    @torch.no_grad()
    def step(self):
        trained = [p for p in self._inner_opt._parameter_list
                   if p.requires_grad]
        grads = [p.grad for p in trained]
        _spu.allreduce_sequence_parallel_grads(trained, grads)
        _hpu.allreduce_gradients(trained, grads, self._hcg, self._bucket_mb)
        super().step()
