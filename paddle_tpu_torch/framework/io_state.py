"""Saving and loading state (counterpart of
``paddle_tpu/framework/io_state.py``), and the bridge of the reference's
parameters handed over as numpy arrays by name.

``save`` / ``load`` write and read the reference's pickle format: a tensor
is stored as ``{"__tensor__": True, "value": ndarray, "stop_gradient":
..., "name": ...}`` inside the pickled dicts, lists and tuples, so a
``.pdparams`` / ``.pdopt`` written by either package loads into the other.
A named tensor (a parameter made with ``ParamAttr(name=)``) loads as a
``Parameter`` with its name that takes no gradient.
A bf16 tensor is stored as the reference stores it, an ``ml_dtypes``
bfloat16 array (saving one needs that package; loading reads its bits
without it).
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "value": _to_numpy(obj),
                "stop_gradient": not obj.requires_grad,
                "name": getattr(obj, "name", None)}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["value"]
            t = _to_tensor(obj["value"], device)
            if obj.get("name"):  # a named tensor keeps its name
                from ..nn.layer import Parameter

                t = Parameter(t, requires_grad=False)
                t.name = obj["name"]
            return t
        return {k: _from_saved(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy, device) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """Pickle ``obj`` (a state dict, nested dicts / lists of tensors and
    plain values) to ``path`` in the reference's format."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, device=None, **configs):
    """What :func:`save` (or the reference's ``save``) wrote to ``path``;
    tensors land on ``device`` (default the CUDA card), or stay numpy
    arrays with ``return_numpy``."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    dev = None if return_numpy else resolve_device(device)
    return _from_saved(obj, return_numpy, dev)


def set_state_dict(module: torch.nn.Module, state: Mapping[str, Any]):
    """Copy ``state`` (tensors or arrays by name) into ``module``'s own
    state, each cast to the dtype and device it has there, as the
    reference's ``Layer.set_state_dict``: a shape mismatch raises, and the
    names missing from ``state`` and those ``module`` lacks are returned
    as ``(missing, unexpected)``. The copy goes through
    ``load_state_dict``, so a layer with a state layout of its own (a
    folded stack's stacked entries) takes it apart."""
    from ..distributed.fleet.layers.mpu import shard_of

    own = module.state_dict()
    sliced = _layouts(module)[3]
    missing, given = [], {}
    for k, t in own.items():
        if k not in state:
            missing.append(k)
            continue
        v = state[k]
        v = v if isinstance(v, torch.Tensor) else _to_tensor(v, t.device)
        if k in sliced and tuple(v.shape) != tuple(t.shape):
            dim, group = sliced[k]  # a full array for a ZeRO-3 slice
            if v.dim() == t.dim() and \
                    v.shape[dim] == t.shape[dim] * group.nranks:
                v = shard_of(v, dim, group.rank, group.nranks)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{tuple(v.shape)} vs model "
                             f"{tuple(t.shape)}")
        given[k] = v.to(t.device, t.dtype)
    module.load_state_dict(given, strict=False)
    return missing, [k for k in state if k not in own]


def state_from_numpy(np_state: Mapping[str, np.ndarray], device,
                     dtype: Optional[torch.dtype] = None, *,
                     expected: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Convert ``{name: ndarray}`` into ``{name: tensor}`` on ``device``
    (cast to ``dtype`` when given). With ``expected`` (a module's
    ``state_dict()``), raise ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape mismatch."""
    if expected is not None:
        missing = sorted(set(expected) - set(np_state))
        extra = sorted(set(np_state) - set(expected))
        if missing or extra:
            raise KeyError(f"state names differ: missing {missing}, "
                           f"unexpected {extra}")
        for name, ref in expected.items():
            got = tuple(np.shape(np_state[name]))
            if got != tuple(ref.shape):
                raise ValueError(f"{name}: shape {got} != expected "
                                 f"{tuple(ref.shape)}")
    out = {}
    for name, arr in np_state.items():
        out[name] = torch.tensor(np.asarray(arr), device=device,
                                 dtype=dtype)
    return out


def _layouts(module: torch.nn.Module):
    """How ``module.state_dict()``'s entries are split over the ranks:
    ``({name: split_axis}, mp group)`` of its model-parallel shards (the
    fleet mp layers' parameters at mp degree > 1; a stacked entry's axis
    one past its block's), ``{name: pipe group}`` of the stacked entries
    of a pipelined stack (each rank holds its stage's slice along dim 0)
    and ``{name: (dim, sharding group)}`` of the ZeRO-3 slices (cut from
    the mp shard)."""
    from ..distributed.fleet.layers.mpu import _mp_group, is_mp_shard
    from ..distributed.fleet.meta_parallel.pipeline_parallel import (
        SpmdPipeline)
    from ..distributed.fleet.meta_parallel.sharding_stage3 import zero3_spec

    group, world, _ = _mp_group()
    shards = {} if world == 1 else {
        n: p.split_axis for n, p in module.named_parameters()
        if is_mp_shard(p)}
    sliced = {n: (zero3_spec(p).dim, zero3_spec(p).group)
              for n, p in module.named_parameters() if zero3_spec(p)}
    cuts = {}
    for prefix, m in module.named_modules():
        if not isinstance(m, SpmdPipeline):
            continue
        for key, leaf in m.stacked_leaves().items():
            name = f"{prefix}.{key}" if prefix else key
            if world > 1 and is_mp_shard(leaf):
                shards[name] = leaf.split_axis + 1
            if zero3_spec(leaf):
                sliced[name] = (zero3_spec(leaf).dim + 1,
                                zero3_spec(leaf).group)
            if m.pipelined:
                cuts[name] = m
    return shards, (group if world > 1 else None), cuts, sliced


def load_numpy_state(module: torch.nn.Module,
                     np_state: Mapping[str, np.ndarray]):
    """Load the reference's state, given as ``{name: ndarray}``, into
    ``module`` on its device and in its dtypes; names and shapes must
    match ``module.state_dict()`` exactly, except that a model-parallel
    shard takes the full array and keeps this rank's part along its
    ``split_axis``, and a pipelined stack's stacked entry takes the full
    ``[L, ...]`` array and keeps this stage's slice, and a ZeRO-3 slice
    its part of that. Returns ``module``."""
    from ..distributed.fleet.layers.mpu import shard_of

    shards, group, cuts, sliced = _layouts(module)
    out = {}
    for k, v in np_state.items():
        if k in cuts:
            v = shard_of(np.asarray(v), 0, cuts[k].stage, cuts[k].num_stages)
        if k in shards:
            v = shard_of(np.asarray(v), shards[k], group.rank, group.nranks)
        if k in sliced:
            dim, g = sliced[k]
            v = shard_of(np.asarray(v), dim, g.rank, g.nranks)
        out[k] = np.ascontiguousarray(v) \
            if k in cuts or k in shards or k in sliced else v
    ref = module.state_dict()
    dev = next(iter(ref.values())).device
    state = state_from_numpy(out, dev, expected=ref)
    module.load_state_dict(
        {k: v.to(ref[k].dtype) for k, v in state.items()}, strict=True)
    return module


def gather_full_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every ZeRO-3 slice all-gathered over
    the sharding group, every model-parallel shard along its
    ``split_axis`` and every pipelined stack's stacked entry along dim 0
    over the pipe group, into the full tensors: the inverse of
    :func:`load_numpy_state`. A collective: every rank calls it."""
    from ..distributed.fleet.layers.mpu import full_of

    shards, group, cuts, sliced = _layouts(module)
    out = {}
    for k, v in module.state_dict().items():
        v = v.detach()
        if k in sliced:
            v = full_of(v.contiguous(), *sliced[k])
        if k in shards:
            v = full_of(v, shards[k], group)
        if k in cuts:
            v = full_of(v.contiguous(), 0, cuts[k]._group)
        out[k] = v
    return out


def _param_layout(p):
    """``(mp split axis or None, mp group, ZeRO-3 spec or None)`` of a
    parameter."""
    from ..distributed.fleet.layers.mpu import _mp_group, is_mp_shard
    from ..distributed.fleet.meta_parallel.sharding_stage3 import zero3_spec

    group, world, _ = _mp_group()
    axis = p.split_axis if world > 1 and is_mp_shard(p) else None
    return axis, group, zero3_spec(p)


def _full_positions(params):
    """Where each of ``params`` (an optimizer's list) stands in the list
    the same model has unpipelined: a pipelined stack's parameters in the
    place of its first, all its blocks there in layer order. Without a
    pipelined stack, each its own index."""
    from ..distributed.fleet.meta_parallel.pipeline_parallel import (
        pipeline_slot)

    out, first, n = [], {}, 0
    for p in params:
        slot = pipeline_slot(p)
        if slot is None:
            out.append(n)
            n += 1
            continue
        pipe, j, k = slot
        if id(pipe) not in first:
            first[id(pipe)] = n
            n += pipe.num_layers * len(pipe._block_params)
        out.append(first[id(pipe)] + pipe.slot_position(j, k))
    return out


def _full_name(p, position):
    """The prefix of a parameter's entries in the full optimizer state:
    its ``ParamAttr`` name, else ``param_{position}`` (the unpipelined
    place). A pipelined stack's parameters are keyed by place: each stage
    holds other objects for the same blocks."""
    from ..distributed.fleet.meta_parallel.pipeline_parallel import (
        pipeline_slot)

    name = getattr(p, "name", None)
    return name if name and pipeline_slot(p) is None \
        else f"param_{position}"


def _optimizer_parts(optimizer):
    """``(rule optimizer, owner of each position or None, sharding
    group)``: the inner optimizer of a ``HybridParallelOptimizer`` and its
    ZeRO-1/2 owners."""
    owner = getattr(optimizer, "_owner", None)
    group = getattr(optimizer, "_sharding_group", None)
    inner = getattr(optimizer, "_inner_opt", optimizer)
    return inner, owner, group


def gather_full_optimizer_state(optimizer) -> Dict[str, torch.Tensor]:
    """The optimizer's state with every parameter-shaped entry as the full
    array (``{name}.{key}``, ``name`` as :func:`_full_name` gives it; the
    scheduler's under ``"LR_Scheduler"``): ZeRO-1/2 state broadcast from
    its owner, ZeRO-3 slices and mp shards gathered, and a pipelined
    stack's entries from every stage, ``i`` the parameter's position in
    the model unpipelined (:func:`_full_positions`; the stages hold the
    same parameters of their blocks in the same places, so each entry is
    all-gathered over the pipe group). A collective: every rank calls it.
    With :func:`load_full_optimizer_state` a run resumes under other
    parallel degrees, pp included."""
    from ..distributed import collective as C
    from ..distributed.fleet.layers.mpu import full_of
    from ..distributed.fleet.meta_parallel.pipeline_parallel import (
        pipeline_slot)

    inner, owner, sgroup = _optimizer_parts(optimizer)
    pos = _full_positions(inner._parameter_list)
    out = {}
    for i, p in enumerate(inner._parameter_list):
        st = inner._accumulators[i]
        if owner is not None and owner[i] is not None:
            st = st or inner._init_state(p)
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    C.broadcast(v, src=sgroup.ranks[owner[i]], group=sgroup)
        if st is None:
            continue
        axis, mgroup, spec = _param_layout(p)
        for k, v in st.items():
            if not isinstance(v, torch.Tensor):  # Lamb's / Lars's marker
                v = torch.tensor(v, dtype=torch.float32)
            v = v.detach()
            if tuple(v.shape) == tuple(p.shape):
                if spec is not None:
                    v = full_of(v.contiguous(), spec.dim, spec.group)
                if axis is not None:
                    v = full_of(v.contiguous(), axis, mgroup)
            slot = pipeline_slot(p)
            if slot is None:
                out[f"{_full_name(p, pos[i])}.{k}"] = v.clone()
                continue
            pipe, j, kk = slot
            base = pos[i] - pipe.slot_position(j, kk)
            for stage, part in enumerate(C.all_gather(
                    None, v.contiguous(), group=pipe._group)):
                out[f"param_{base + pipe.slot_position(j, kk, stage)}"
                    f".{k}"] = part
    sched = inner.state_dict().get("LR_Scheduler")
    if sched is not None:
        out["LR_Scheduler"] = sched
    return out


def load_full_optimizer_state(optimizer, state):
    """Load :func:`gather_full_optimizer_state`'s full arrays into
    ``optimizer``, each cut to this rank's layout of its parameter (only
    the owner's under ZeRO-1/2)."""
    from ..distributed.fleet.layers.mpu import shard_of

    inner, owner, _ = _optimizer_parts(optimizer)
    pos = _full_positions(inner._parameter_list)
    local = {}
    if "LR_Scheduler" in state:
        local["LR_Scheduler"] = state["LR_Scheduler"]
    for i, p in enumerate(inner._parameter_list):
        if owner is not None and owner[i] not in (None, optimizer._me):
            continue
        axis, mgroup, spec = _param_layout(p)
        name = _full_name(p, pos[i])
        for k, ref in inner._init_state(p).items():
            v = state.get(f"{name}.{k}")
            if v is None or not isinstance(ref, torch.Tensor):
                continue
            v = torch.as_tensor(v)
            if tuple(ref.shape) == tuple(p.shape):
                if axis is not None:
                    v = shard_of(v, axis, mgroup.rank, mgroup.nranks)
                if spec is not None:
                    v = shard_of(v, spec.dim, spec.group.rank,
                                 spec.group.nranks)
            local[f"{inner._state_name(i)}.{k}"] = v.contiguous()
    return inner.set_state_dict(local)


__all__ = ["gather_full_optimizer_state", "gather_full_state", "load",
           "load_full_optimizer_state", "load_numpy_state", "save",
           "set_state_dict", "state_from_numpy"]
