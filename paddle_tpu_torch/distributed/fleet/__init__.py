"""Fleet: the hybrid-parallel training entry (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``).

``fleet.init(strategy=...)`` joins the default process group and builds
the topology ``(data, pipe, sharding, sep, model)``, dp filled up to the
world size, with one process group per axis slice;
``distributed_model`` broadcasts the parameters so every rank starts
equal (all of them over the data and sharding groups, the replicated ones
over mp); ``distributed_optimizer`` wraps the optimizer into a
:class:`HybridParallelOptimizer`; :class:`DistTrainStep` runs one step.
The model is built after ``fleet.init``: its mp layers read the model
parallel group then.

ZeRO (``sharding_degree > 1``, stage 1 or 2) shards the optimizer by whole
parameters, as upstream Paddle's ``DygraphShardingOptimizer`` does: each
parameter has one owner in its sharding group (greedy by size, in
parameter order), and only the owner keeps its AdamW moments and, under
``multi_precision``, its f32 master, and updates it; each owner then
broadcasts its updated parameters, packed in one buffer per dtype. The
gradients reach every rank by the data group's all-reduce, so the update
is the unsharded one bit for bit (AdamW is elementwise). Stage 2 also
drops, before the update, the gradients a rank does not own. Stage 3
(``meta_parallel/sharding_stage3.py``) cuts the parameters themselves to
slices over the sharding group in ``distributed_model``: every rank
updates its slices, with slice-shaped moments, and broadcasts nothing.

``strategy.gradient_merge`` wraps the optimizer in a
:class:`GradientMergeOptimizer` (``distributed_optimizer``, as the
reference does); the quantized gradient wire (``grad_comm``) replaces the
data group's f32 all-reduce where the reference's explicit exchange runs.

:class:`DistTrainStep` takes the *global* batch on every rank, as the
reference does, and keeps the rank's rows over the data axes (data and
sharding, data-major): an array whose first dim does not divide stays
whole on every rank (the reference's ``data_spec_for`` gives ``P()``).
It runs forward and backward, sums the sequence-parallel parameters'
gradients over mp, averages the gradients over the data (x sep) ranks in
flat buckets (``grad_comm``), then steps the optimizer. It returns the
global mean loss. While the loss runs on split rows, every reduction over
the batch that the port's functionals make is global, as in the
reference's one program over the global batch (ROADMAP.md §C.26): a
masked or ``ignore_index`` / class-weighted mean divides by the count
(or weight) summed over the data group, a ``reduction="sum"`` is scaled
by the group's size (``nn/functional/loss.py``), and batch norm in
training sums its statistics over the group (``nn/functional/norm.py``),
so the running buffers come out equal on every rank. Only batch tensors
whose dim 0 is the first batch tensor's are cut (a ``[C]`` class weight
stays whole). A reduction of the user's own over the batch sees the
rank's rows.

The sep axis (``sep_degree > 1``, context parallelism): after its rows,
each rank keeps its contiguous ``T / sep`` block of dim 1 of every batch
tensor of rank >= 2 (PaddleNLP's ``split_inputs_sequence_dim``; a length
that does not divide raises). The model runs under
``ring_attention.sequence_split``: its attention is the ring over the sep
group and its default positions start at the block's first. The loss's
denominators, the loss and the replicated parameters' gradients then
count and average over the data x sep ranks. An op of the user's own that
mixes tokens along the sequence, other than attention, sees only the
rank's block (ROADMAP.md §C).

Expert parallelism: a capacity ``MoELayer`` built after ``fleet.init``
keeps its slice of the experts over the expert axis
(``incubate/moe.py``). Its slices' gradients are summed over the ranks
holding the same experts and divided by the data x sep degree; under ZeRO
each slice stays with the rank that holds it, and the global-norm clip
sums the slices' squares once over the expert axis.

Pipeline parallelism (``pp_degree > 1``): a model whose layer stack is a
pipelined ``meta_parallel.SpmdPipeline`` (GPT / Llama built after
``fleet.init``, or a ``PipelineLayer``) trains through the same
``DistTrainStep``, which hands its forward and backward to the per-rank
schedule (``meta_parallel/pipeline_parallel.py::forward_backward``: the
replicated parameters' gradients come back summed over the pipe group);
the rest of the step is the one above. ``distributed_model`` also
broadcasts the replicated parameters over the pipe group and wraps a
``PipelineLayer`` in ``PipelineParallel``; the global-norm clip sums the
stage-local squares over the pipe group and counts the replicated
parameters once. ZeRO-3 and the sep axis compose with it: each stage
slices the parameters it holds, the clip sums the slices' squares over
sharding before pipe, and the loss's split (its token group, the
sequence split) spans the whole schedule, backward included.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Optional

import numpy as np
import torch

from ...incubate.moe import is_expert_slice
from ...jit import TrainStep
from ...nn.functional import loss as _loss
from ...nn.functional import ring_attention as _ring
from ...optimizer import ClipGradByGlobalNorm, ClipGradByNorm
from .. import collective as C
from .. import grad_comm
from ..env import get_rank, get_world_size, init_parallel_env
from . import topology  # noqa: F401
from .layers import mpu  # noqa: F401
from .strategy import DistributedStrategy, check_ported
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from .utils import hybrid_parallel_util as _hpu
from .utils import (recompute, recompute_hybrid,  # noqa: F401
                    recompute_sequential, sequence_parallel_utils)

_strategy: Optional[DistributedStrategy] = None


class UserDefinedRoleMaker:
    """Accepted for script compatibility; collective roles are implicit."""

    def __init__(self, *a, **k):
        pass


class PaddleCloudRoleMaker(UserDefinedRoleMaker):
    pass


def init(role_maker=None, is_collective: bool = False,
         strategy: Optional[DistributedStrategy] = None):
    """fleet.init: check the strategy, join the default group, fill the
    unset layout knobs from the auto-parallel planner when
    ``strategy.auto_plan`` or ``PADDLE_TPU_AUTO_PLAN=1`` (manual settings
    win), build the hybrid topology and its groups."""
    global _strategy
    strategy = strategy or DistributedStrategy()
    check_ported(strategy)
    init_parallel_env()
    world = get_world_size()
    if getattr(strategy, "auto_plan", False) or \
            os.environ.get("PADDLE_TPU_AUTO_PLAN", "") == "1":
        from ..auto_parallel import planner as _planner

        _planner.apply_auto_plan(strategy, world)
    hc = strategy.hybrid_configs
    mp = int(hc.get("mp_degree", 1))
    pp = int(hc.get("pp_degree", 1))
    sh = int(hc.get("sharding_degree", 1))
    sep = int(hc.get("sep_degree", 1))
    dp = int(hc.get("dp_degree", 1))
    fixed = mp * pp * sh * sep
    if dp in (-1, 0) or dp * fixed != world:
        if world % fixed:
            raise ValueError(
                f"hybrid degrees mp={mp} pp={pp} sharding={sh} sep={sep} "
                f"do not divide the world size {world}")
        dp = world // fixed
        hc["dp_degree"] = dp
    _strategy = strategy
    topo = CommunicateTopology(("data", "pipe", "sharding", "sep", "model"),
                               (dp, pp, sh, sep, mp))
    set_hybrid_communicate_group(HybridCommunicateGroup(topo))


def is_initialized() -> bool:
    return get_hybrid_communicate_group() is not None


def fleet_strategy() -> Optional[DistributedStrategy]:
    return _strategy


def worker_index() -> int:
    return get_rank()


def worker_num() -> int:
    return get_world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker():
    C.barrier()


def save_persistables(executor=None, dirname=None, main_program=None, mode=0,
                      model=None):
    """PS-mode checkpoint parity (reference ``fleet/__init__.py:168-199``):
    write every parameter of ``model`` through ``distributed.checkpoint``
    under ``dirname/persistables`` (every rank calls it; an mp shard or a
    ZeRO-3 slice is written as its part of the whole, by canonical name)
    and return the names. Raises ``ValueError`` without ``dirname`` or
    with nothing to save. The reference's other source, a static
    Program's parameters, waits for ``paddle.static`` (ROADMAP.md
    §A.9b)."""
    import os

    if dirname is None:
        raise ValueError("save_persistables requires dirname")
    if model is None:
        raise NotImplementedError(
            "save_persistables from a static Program's parameters waits "
            "for paddle.static, see ROADMAP.md §A.9b: pass model=<Layer>")
    from ..checkpoint import save_state_dict
    from ..checkpoint.converter import _entries, _layout_spec, _value

    params = {id(p) for p in model.parameters()}
    state = {k: _value(v, _layout_spec(v))
             for k, v in _entries(model).items() if id(v) in params}
    if not state:
        raise ValueError(
            "save_persistables found no parameters: pass model=<Layer> "
            "with parameters")
    save_state_dict(state, os.path.join(dirname, "persistables"))
    return list(state)


def init_server(*model_paths, **kwargs):
    """PS-mode parity: there are no server processes; tables are split over
    the mesh (``distributed.ps``). A no-op, so PS-mode scripts run under
    the collective runtime."""


def run_server():
    """PS-mode parity no-op (no server loop to run; see distributed.ps)."""


def init_worker(scopes=None):
    """PS-mode parity: a worker needs no table-RPC set-up."""


def stop_worker():
    """PS-mode parity no-op."""


def is_server() -> bool:
    return False


def is_worker() -> bool:
    return True


def _require_hcg():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init() first")
    return hcg


def _sharding_stage(strategy) -> int:
    return int((strategy or DistributedStrategy()).sharding_configs.get(
        "stage", 1))


def distributed_model(model):
    """Broadcast ``model``'s parameters so every rank starts equal, then at
    ZeRO-3 cut them to this rank's slices; returns the model, a
    ``PipelineLayer`` at pp > 1 wrapped in ``PipelineParallel`` (reference
    ``fleet/__init__.py:270-287``)."""
    return _distribute(model, _sharding_stage(_strategy))


def _distribute(model, stage):
    hcg = _require_hcg()
    _hpu.broadcast_dp_parameters(model, hcg)
    _hpu.broadcast_sharding_parameters(model, hcg)
    _hpu.broadcast_sep_parameters(model, hcg)
    _hpu.broadcast_mp_parameters(model, hcg)
    _hpu.broadcast_pp_replicated_parameters(model, hcg)
    if stage == 3 and hcg.get_sharding_parallel_world_size() > 1:
        _z3.shard_parameters(model, hcg.get_sharding_parallel_group())
    if hcg.get_pipe_parallel_world_size() > 1 and isinstance(
            model, _pp.PipelineLayer):
        return _pp.PipelineParallel(model, hcg, _strategy)
    return model


def _partition(params, world):
    """Owner (sharding rank) of each parameter: in order, to the rank
    holding the fewest elements so far; None for an expert slice, which
    its own rank updates."""
    load = [0] * world
    owner = []
    for p in params:
        if is_expert_slice(p):
            owner.append(None)
            continue
        r = min(range(world), key=lambda i: load[i])
        owner.append(r)
        load[r] += p.numel()
    return owner


def _split_groups(hcg, p):
    """The groups over whose ranks the parts of ``p`` lie, in the order its
    squares are summed: sharding (a ZeRO-3 slice), model (an mp shard),
    expert (an expert slice). Empty for a whole parameter; the pipe group
    is not among them (a stage holds its parameters whole)."""
    out = []
    if is_zero3_slice(p):
        out.append(hcg.get_sharding_parallel_group())
    if mpu.is_mp_shard(p) and hcg.get_model_parallel_world_size() > 1:
        out.append(hcg.get_model_parallel_group())
    if is_expert_slice(p):
        out.append(hcg.get_expert_parallel_group())
    return tuple(out)


def _split_sum(hcg, p, squares):
    """Sum ``squares`` (a tensor of sums of squares of ``p``'s local part)
    in place over the ranks holding ``p``'s other parts."""
    for group in _split_groups(hcg, p):
        C.all_reduce(squares, group=group)
    return squares


class HybridParallelOptimizer:
    """``fleet.distributed_optimizer``'s product: the inner optimizer's
    step over the hybrid groups. A parameter split over ranks (an mp
    shard, a ZeRO-3 slice, an expert slice; :func:`_split_groups`) has its
    norms taken whole: ``ClipGradByGlobalNorm`` sums the squares of the
    split parameters' parts over their groups, ``ClipGradByNorm`` and the
    trust ratios of ``Lamb`` / ``Lars`` each parameter's (the hook
    ``_split_sum`` on the inner optimizer). With sharding > 1 the update
    is sharded by parameter (see the module docstring). Anything else is
    the inner optimizer's."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy or _strategy or DistributedStrategy()
        self._stage = _sharding_stage(self._strategy)
        sg = (self._hcg.get_sharding_parallel_group()
              if self._hcg is not None else None)
        self._sharding_group = sg
        # ZeRO-3: every rank updates its slices, nothing is broadcast
        self._shard_states = sg is not None and sg.nranks > 1 \
            and self._stage != 3
        self._owner = (_partition(optimizer._parameter_list, sg.nranks)
                       if self._shard_states else None)
        self._me = (self._hcg.get_sharding_parallel_rank()
                    if self._hcg is not None else 0)
        if self._hcg is not None:
            rules = (optimizer._inner
                     if isinstance(optimizer, GradientMergeOptimizer)
                     else optimizer)
            # bound to the group, not to this wrapper: the inner optimizer
            # must not keep its wrapper (and the model) alive in a cycle
            rules._split_sum = functools.partial(_split_sum, self._hcg)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def owns(self, i) -> bool:
        """Whether this rank updates parameter ``i``."""
        return self._owner is None or self._owner[i] in (None, self._me)

    def _clip(self, pg):
        """The inner optimizer's clip over the whole model: a
        ``ClipGradByNorm`` with each split gradient's squares summed over
        its groups; a ``ClipGradByGlobalNorm`` with the squares of the
        gradients of each kind of split (``_split_groups``) summed over
        those groups, those of the stage-local parameters over the pipe
        group, the parameters replicated over pp counted once."""
        clip = self._inner_opt._grad_clip
        if self._hcg is None:
            return clip(pg)
        if isinstance(clip, ClipGradByNorm):
            return clip(pg, split_sum=functools.partial(_split_sum,
                                                        self._hcg))
        pp = self._hcg.get_pipe_parallel_group()
        kinds = {}  # (split groups, stage-local) -> squares
        for p, g in pg:
            if g is not None:
                kinds.setdefault(
                    (_split_groups(self._hcg, p), is_pipeline_local(p)),
                    []).append(torch.sum(torch.square(g.float())))
        if not isinstance(clip, ClipGradByGlobalNorm) or (
                pp.nranks == 1 and all(not k[0] for k in kinds)):
            return clip(pg)
        keys = list(kinds)
        sums = (torch.stack([torch.stack(kinds[k]).sum() for k in keys])
                if keys else torch.zeros(0, device=pg[0][0].device))
        for group in dict.fromkeys(g for k in keys for g in k[0]):
            idx = [i for i, k in enumerate(keys) if group in k[0]]
            part = sums[idx]
            C.all_reduce(part, group=group)
            sums[idx] = part
        local = [i for i, k in enumerate(keys) if k[1]]
        gsq = sums[[i for i, k in enumerate(keys) if not k[1]]].sum()
        if pp.nranks > 1:
            lsum = sums[local].sum()
            C.all_reduce(lsum, group=pp)
            gsq = gsq + lsum
        gnorm = torch.sqrt(gsq)
        scale = clip.clip_norm / torch.clamp(gnorm, min=clip.clip_norm)
        for _, g in pg:
            if g is not None:
                g.mul_(scale)
        return pg

    @torch.no_grad()
    def step(self):
        opt = self._inner_opt
        pg = [(p, p.grad if p.requires_grad else None)
              for p in opt._parameter_list]
        if isinstance(opt, GradientMergeOptimizer):
            pg = opt._merge(pg)
            if pg is None:  # within a merge cycle: nothing to apply
                return
            opt = opt._inner
        if opt._grad_clip is not None:
            pg = self._clip(pg)
        if self._stage == 2:
            for i, (p, _) in enumerate(pg):
                if not self.owns(i):
                    p.grad = None
            pg = [(p, g if self.owns(i) else None)
                  for i, (p, g) in enumerate(pg)]
        lr = float(np.float32(opt.get_lr()))
        for i, (p, g) in enumerate(pg):
            if g is not None and self.owns(i):
                opt._update(i, p, g, lr)
        if self._shard_states:
            self._broadcast_updates()

    def _broadcast_updates(self):
        params = self._inner_opt._parameter_list
        sg = self._sharding_group
        for r in range(sg.nranks):
            mine = [p for i, p in enumerate(params)
                    if self._owner[i] == r and p.requires_grad]
            for dtype in dict.fromkeys(p.dtype for p in mine):
                same = [p for p in mine if p.dtype == dtype]
                flat = torch.cat([p.detach().reshape(-1) for p in same])
                C.broadcast(flat, src=sg.ranks[r], group=sg)
                if r != self._me:
                    off = 0
                    for p in same:
                        p.data.copy_(flat[off:off + p.numel()].view_as(p))
                        off += p.numel()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def _grad_wire(self):
        """The quantized gradient exchange of this optimizer's trainable
        parameters, or None (``hybrid_parallel_util.wire_exchange``)."""
        if self._hcg is None:
            return None
        return _hpu.wire_exchange(
            [p for p in self._inner_opt._parameter_list if p.requires_grad],
            self._hcg, self._strategy)

    def state_dict(self):
        """This rank's state: under ZeRO-1/2, that of the parameters it owns
        (by position in the full parameter list), under ZeRO-3 its slices;
        with the error-feedback wire, the rank's residuals under
        ``"grad_comm.residual_{bucket}"``."""
        out = self._inner_opt.state_dict()
        wire = self._grad_wire()
        if wire is not None and wire.residuals is not None:
            for b, r in enumerate(wire.residuals):
                out[f"grad_comm.residual_{b}"] = r.clone()
        return out

    def set_state_dict(self, state):
        wire = self._grad_wire()
        if wire is not None and wire.residuals is not None:
            state = dict(state)
            for b in range(len(wire.residuals)):
                r = state.pop(f"grad_comm.residual_{b}", None)
                if r is not None:
                    wire.residuals[b] = torch.as_tensor(r).to(
                        wire.residuals[b].device, torch.float32).clone()
        return self._inner_opt.set_state_dict(state)


class GradientMergeOptimizer:
    """``strategy.gradient_merge`` (counterpart of the reference's
    ``GradientMergeOptimizer``, ``fleet/__init__.py:389-649``): the
    gradients of ``k_steps`` calls are added in f32 accumulators (one per
    parameter, shaped as the parameter: a ZeRO-3 slice's is slice-shaped),
    and every ``k_steps``-th call applies one update of the inner optimizer
    (its clip, decay and rule) with the merged gradient, divided by ``k``
    with ``avg``; the other calls leave the parameters as they are.

    The reference's functional semantics (the step ``TrainStep`` compiles),
    whatever drives ``step``: the cycle counter advances on a call in which
    some parameter has a gradient; a parameter that had one at some call
    of the cycle (an exact zero included) is updated at the boundary, even
    if it has none at the boundary call; one that had none all cycle is
    left untouched; the boundary zeroes every accumulator.
    ``state_dict`` holds the inner state as ``{name}.inner_{key}`` beside
    ``{name}.gm_acc`` / ``gm_ctr`` / ``gm_saw`` (``name`` the parameter's
    ``ParamAttr`` name or ``param_{i}``, as the inner optimizer's keys), so
    a checkpoint taken mid-cycle resumes the cycle."""

    def __init__(self, inner, k_steps=1, avg=True):
        self._inner = inner
        self._k = max(int(k_steps), 1)
        self._avg = bool(avg)
        self._parameter_list = inner._parameter_list
        n = len(self._parameter_list)
        self._acc = [None] * n
        self._saw = [False] * n
        self._ctr = 0

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self._inner, name)

    def _merge(self, pg):
        """Add the gradients of ``pg`` (parameter, gradient or None); at a
        boundary return the pairs to apply (the merged gradient of each
        parameter that had one this cycle, else None) and restart the
        cycle, otherwise None."""
        live = [g is not None and p.requires_grad for p, g in pg]
        if not any(live):
            return None
        for i, ((p, g), ok) in enumerate(zip(pg, live)):
            if ok:
                g = g.detach().float()
                self._acc[i] = g.clone() if self._acc[i] is None \
                    else self._acc[i].add_(g)
                self._saw[i] = True
        self._ctr += 1
        if self._ctr % self._k:
            return None
        scale = 1.0 / self._k if self._avg else 1.0
        out = [(p, (self._acc[i] * scale).to(p.dtype)
                if self._saw[i] and p.requires_grad else None)
               for i, (p, _) in enumerate(pg)]
        self._acc = [None] * len(pg)
        self._saw = [False] * len(pg)
        return out

    @torch.no_grad()
    def step(self):
        pg = self._merge([(p, p.grad if p.requires_grad else None)
                          for p in self._parameter_list])
        if pg is not None:
            self._inner._apply(pg)

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        out = {}
        for k, v in self._inner.state_dict().items():
            name, dot, key = k.rpartition(".")  # a state key has no dot
            out[f"{name}.inner_{key}" if dot else k] = v
        for i, p in enumerate(self._parameter_list):
            if not p.requires_grad:
                continue
            name = self._inner._state_name(i)
            acc = self._acc[i]
            out[f"{name}.gm_acc"] = (acc.clone() if acc is not None
                                     else torch.zeros_like(
                                         p, dtype=torch.float32))
            out[f"{name}.gm_ctr"] = torch.tensor(self._ctr,
                                                 dtype=torch.int32)
            out[f"{name}.gm_saw"] = torch.tensor(int(self._saw[i]),
                                                 dtype=torch.int32)
        return out

    def set_state_dict(self, state):
        if not any(".gm_" in k for k in state):
            # a checkpoint of a plain run: the inner state, a fresh cycle
            self._acc = [None] * len(self._parameter_list)
            self._saw = [False] * len(self._parameter_list)
            self._ctr = 0
            return self._inner.set_state_dict(state)
        inner = {}
        for k, v in state.items():
            name, _, key = k.rpartition(".")
            if key.startswith("inner_"):
                inner[f"{name}.{key[len('inner_'):]}"] = v
            elif not key.startswith("gm_"):
                inner[k] = v
        for i, p in enumerate(self._parameter_list):
            name = self._inner._state_name(i)
            acc = state.get(f"{name}.gm_acc")
            if acc is None:
                continue
            saw = state.get(f"{name}.gm_saw")
            acc = torch.as_tensor(acc).to(p.device, torch.float32)
            # a checkpoint without the flag: infer it from the accumulator
            self._saw[i] = bool(int(saw)) if saw is not None \
                else bool(acc.ne(0).any())
            self._acc[i] = acc.clone() if self._saw[i] else None
            self._ctr = int(state[f"{name}.gm_ctr"])
        return self._inner.set_state_dict(inner)


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` wrapped for the hybrid groups (the reference's
    ``fleet/__init__.py:656-674``): swapped by the meta-optimizers
    (:func:`_apply_meta_optimizers`), then in a
    ``GradientMergeOptimizer`` with ``strategy.gradient_merge``, then in a
    ``HybridParallelOptimizer`` (which, before ``fleet.init``, is the
    inner optimizer's step)."""
    strategy = strategy or _strategy or DistributedStrategy()
    check_ported(strategy)
    for knob in ("dgc", "localsgd", "adaptive_localsgd"):
        if getattr(strategy, knob, False):
            import warnings

            warnings.warn(
                f"DistributedStrategy.{knob} is ignored: the gradient "
                "all-reduce is exact and runs every step (as in the "
                "reference, a deliberate non-goal)", stacklevel=2)
    optimizer = _apply_meta_optimizers(optimizer, strategy)
    if getattr(strategy, "gradient_merge", False):
        cfg = dict(getattr(strategy, "gradient_merge_configs", {}) or {})
        optimizer = GradientMergeOptimizer(
            optimizer, k_steps=int(cfg.get("k_steps", 1)),
            avg=bool(cfg.get("avg", True)))
    return HybridParallelOptimizer(optimizer, get_hybrid_communicate_group(),
                                   strategy)


def _apply_meta_optimizers(optimizer, strategy):
    """The strategy's optimizer swaps (the reference's
    ``fleet/__init__.py:677-724``, upstream's ``lars_optimizer.py`` /
    ``lamb_optimizer.py`` meta-optimizers): with ``strategy.lars`` a
    ``Momentum`` becomes ``Lars``, with ``strategy.lamb`` an ``Adam`` /
    ``AdamW`` becomes ``Lamb``, each from the ``*_configs`` and the
    wrapped optimizer's rate, moments' betas, parameters, clip and
    regularizer (as the reference: ``multi_precision`` and AdamW's decay
    are not carried)."""
    from ... import optimizer as opt_mod

    if getattr(strategy, "lars", False) and isinstance(
            optimizer, opt_mod.Momentum):
        cfg = dict(getattr(strategy, "lars_configs", {}) or {})
        new = opt_mod.Lars(
            learning_rate=optimizer._learning_rate,
            momentum=optimizer._momentum,
            lars_coeff=float(cfg.get("lars_coeff", 0.001)),
            lars_weight_decay=float(cfg.get("lars_weight_decay", 0.0005)),
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay",
                                              []),
            epsilon=float(cfg.get("epsilon", 0.0)),
            parameters=optimizer._parameter_list,
            grad_clip=optimizer._grad_clip)
        new._regularizer = optimizer._regularizer
        return new
    if getattr(strategy, "lamb", False) and isinstance(optimizer,
                                                       opt_mod.Adam):
        cfg = dict(getattr(strategy, "lamb_configs", {}) or {})
        excl = list(cfg.get("exclude_from_weight_decay", []) or [])
        new = opt_mod.Lamb(
            learning_rate=optimizer._learning_rate,
            lamb_weight_decay=float(cfg.get("lamb_weight_decay", 0.01)),
            beta1=optimizer._beta1, beta2=optimizer._beta2,
            epsilon=optimizer._epsilon,
            parameters=optimizer._parameter_list,
            grad_clip=optimizer._grad_clip,
            exclude_from_weight_decay_fn=(
                (lambda name: any(x in (name or "") for x in excl))
                if excl else None))
        new._regularizer = optimizer._regularizer
        return new
    return optimizer


class DistTrainStep(TrainStep):
    """One hybrid-parallel training step over the global batch (see the
    module docstring). Returns the global mean loss, detached."""

    def __init__(self, model, loss_fn, optimizer):
        if not isinstance(optimizer, HybridParallelOptimizer):
            optimizer = HybridParallelOptimizer(optimizer)
        super().__init__(model, loss_fn, optimizer)
        hcg = _require_hcg()
        self._hcg = hcg
        self._data_group = hcg.get_data_sharding_parallel_group()
        self._data_rank = hcg.get_data_sharding_parallel_rank()
        self._sep_group = (hcg.get_sep_parallel_group()
                           if hcg.get_sep_parallel_world_size() > 1
                           else None)
        self._bucket_mb = grad_comm.resolve_config(
            optimizer._strategy).bucket_mb
        self._pipe = _pp.pipelined_stack(model)
        self._zero3 = _z3.is_zero3_model(model)

    def _rows(self, v, batch):
        """This rank's rows of ``v`` when its dim 0 is the batch's (that of
        the first batch tensor) and divides over the data ranks; anything
        else (a ``[C]`` class weight) stays whole."""
        n = self._data_group.nranks
        if not isinstance(v, torch.Tensor) or v.dim() == 0 or n == 1 \
                or v.shape[0] != batch or v.shape[0] % n:
            return v, False
        k = v.shape[0] // n
        return v[self._data_rank * k:(self._data_rank + 1) * k], True

    def _sequence(self, v):
        """This rank's block of dim 1 at sep > 1 (tensors of rank >= 2)."""
        g = self._sep_group
        if g is None or not isinstance(v, torch.Tensor) or v.dim() < 2:
            return v, False
        if v.shape[1] % g.nranks:
            raise ValueError(
                f"sep_degree {g.nranks} does not divide the sequence "
                f"length {v.shape[1]} (dim 1 of a batch tensor "
                f"{tuple(v.shape)})")
        k = v.shape[1] // g.nranks
        return v[:, g.rank * k:(g.rank + 1) * k], True

    def _token_group(self, rows, seq):
        """The group the loss averages over: the ranks holding distinct
        tokens (data x sep, data or sep as the batch split), or None."""
        if rows and seq:
            return self._hcg.get_dp_sep_parallel_group()
        if rows:
            return self._data_group
        return self._sep_group if seq else None

    def __call__(self, *batch):
        first = next((v for v in batch if isinstance(v, torch.Tensor)
                      and v.dim() > 0), None)
        size = None if first is None else first.shape[0]
        rows = [self._rows(v, size) for v in batch]
        seqs = [self._sequence(v) for v, _ in rows]
        args = [v for v, _ in seqs]
        split_seq = any(s for _, s in seqs)
        split_rows = any(s for _, s in rows)
        group = self._token_group(split_rows, split_seq)
        # rows left whole: every data rank holds the same tokens
        replica = (self._data_group if not split_rows
                   and self._data_group.nranks > 1 else None)
        trained = [p for p in self._params if p.requires_grad]
        # the split spans the backward too: a ring's rotations back and a
        # recomputed block run there
        with _loss.split_batch(group, replica), _ring.sequence_split(
                self._sep_group if split_seq else None):
            if self._pipe is None:
                with (_z3.forward_scope() if self._zero3
                      else contextlib.nullcontext()):
                    loss = self._loss_fn(self._model, *args)
                grads = torch.autograd.grad(loss, trained, allow_unused=True)
            else:
                loss, grads = _pp.forward_backward(
                    self._pipe, self._model, self._loss_fn, args, trained,
                    group)
        sequence_parallel_utils.allreduce_sequence_parallel_grads(
            trained, grads)
        _hpu.allreduce_gradients(trained, grads, self._hcg, self._bucket_mb)
        for p, g in zip(trained, grads):
            p.grad = g
        del grads  # ZeRO-2 drops the gradients it does not own
        self._opt.step()
        for p in trained:
            p.grad = None
        loss = loss.detach()
        if group is not None:
            loss = loss.clone()
            C.all_reduce(loss, C.ReduceOp.AVG, group=group)
        return loss


from . import meta_parallel  # noqa: E402,F401  (needs the classes above)
from .meta_parallel import pipeline_parallel as _pp  # noqa: E402
from .meta_parallel.pipeline_parallel import is_pipeline_local  # noqa: E402
from .meta_parallel import sharding_stage3 as _z3  # noqa: E402
from .meta_parallel.sharding_stage3 import is_zero3_slice  # noqa: E402
from . import elastic  # noqa: E402,F401
from .. import ps  # noqa: E402,F401  (paddle.distributed.ps)

__all__ = ["CommunicateTopology", "DistTrainStep", "DistributedStrategy",
           "GradientMergeOptimizer", "HybridCommunicateGroup",
           "HybridParallelOptimizer",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "barrier_worker",
           "distributed_model", "distributed_optimizer", "fleet_strategy",
           "get_hybrid_communicate_group", "init", "init_server",
           "init_worker", "is_first_worker", "is_initialized", "is_server",
           "is_worker", "run_server", "save_persistables", "stop_worker",
           "worker_index", "worker_num"]
