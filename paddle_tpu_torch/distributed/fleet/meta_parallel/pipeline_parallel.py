"""Pipeline parallelism (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``), on
``torch.distributed``, one process per pipeline rank.

The reference compiles the whole schedule into one SPMD program: the
blocks' parameters stacked along a leading layer dim sharded over the
``pp`` mesh axis, ``lax.ppermute`` between stages, ``jax.grad`` through
the schedule. PyTorch has no such program, so the port runs the
reference's MPMD form of the same schedules (its ``distributed/mpmd.py``
drives stages this way):

* :class:`SpmdPipeline` keeps, on pipe rank ``s``, the real blocks of its
  chunks (chunk ``c`` of the stack lives on stage ``c % S``, the
  reference's interleaved layout) in an ``nn.ModuleList``. At one stage it
  is the reference's layer fold: the blocks in order, per-call ``extra``
  tensors (an encoder's mask) given to every block. Its ``state_dict``
  holds the reference's stacked layout (``ln_1.weight`` ->
  ``ln_1__weight`` of shape ``[L, ...]`` in ``_layer_order``; a buffer's
  key ends in ``_stacked``), so a folded or pipelined model and the
  reference's exchange checkpoints; at ``S > 1`` each rank's entries are
  its ``[L / S, ...]`` slice, which ``framework.io_state`` gathers and
  cuts.
* The per-rank schedule runner (:func:`run_schedule`) replays the rank's row
  of :func:`phased_stage_table`, the ``(tick, F/B, micro-batch, chunk)``
  ops the SPMD schedules execute. A forward op runs the caller's whole
  loss function on the micro-batch; inside it the pipelined stack ignores
  its input unless it holds the first chunk, takes the activation from the
  previous stage instead, applies its chunk and either returns (the last
  chunk: the loss function goes on) or sends the output on and ends the
  micro-batch there. So an opaque ``loss_fn(model, *batch)`` works
  unchanged; the layers before the stack (the embedding) run needlessly
  on later stages and get no gradient there. A backward op receives the
  output's cotangent, runs ``torch.autograd.backward`` and sends the
  input's cotangent back. ``1f1b`` keeps at most ``S - s`` micro-batches
  in flight on stage ``s``; ``zero_bubble`` takes the input's gradient in
  its tick and defers the weight gradients to one pass after the drain;
  the interleaved schedule (``V > 1``) follows the table's chunk index.
  All of them sum the same gradients, so they agree up to reassociation.
* A masked-mean loss cannot divide by the batch's count while 1F1B runs
  the first micro-batches' backward: in a micro-batch the loss's
  denominator is recorded and taken as 1 (``nn/functional/loss.py``), and
  once every micro-batch is in, the last stage sums the counts (over the
  data group too when the batch is split) and broadcasts the divisor over
  the pipe group, by which every stage divides its gradients. A loss that
  records no count is a per-micro-batch mean; the divisor is then M.
* The parameters outside the pipelined stack (embeddings, final norm,
  tied head) are replicated on every pp rank, as in the reference; their
  gradients are summed over the pipe group in one bucket, so they stay
  bit-equal across the pp ranks.
* ZeRO-3 and the sep axis run inside a stage. The ranks of a sharding
  group and of a sep group share a pipe stage (the topology's order), so
  they replay the same row of the table and their gathers,
  reduce-scatters and ring rotations meet in one order. Each stage
  slices its own blocks (and the replicated parameters); a forward op
  runs in a ZeRO-3 forward scope of its own, closed when the op ends
  (by ``_StageDone`` too), so no gathered weight outlives it and a
  backward op gathers again what it reads (zero bubble's deferred pass a
  second time). ``fleet.DistTrainStep`` keeps the sequence split over
  the whole schedule: every forward op and every backward op (a ring's
  rotations back, a recomputed block) sees the rank's block, and the
  boundaries carry ``[mb, T / sep, H]``.

:class:`PipelineLayer` folds the longest homogeneous run of its
``LayerDesc`` list into a :class:`SpmdPipeline`; the layers around it are
replicated. :class:`PipelineParallel` is ``fleet.distributed_model``'s
wrapper of one, with ``train_batch`` / ``eval_batch``.
"""
from __future__ import annotations

import collections
import contextlib
import os
import warnings
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ....nn.functional import loss as _loss
from ....nn.layer import Layer, LayerList
from ... import collective as C
from ... import grad_comm
from ..topology import get_hybrid_communicate_group
from ..utils.recompute_helper import policy_for_granularity, recompute
from . import sharding_stage3 as _z3
from .pp_utils.p2p_communication import P2pHelper

#: what the schedule runner did, for the on-card check: forward /
#: backward ops and the bytes of replicated gradients summed over the pipe
#: group
counts: collections.Counter = collections.Counter()


def reset_counts():
    counts.clear()


# ------------------------------------------------- schedule configuration --
PP_SCHEDULES = ("gpipe", "1f1b", "zero_bubble")


@dataclass(frozen=True)
class PpScheduleConfig:
    """Resolved pipeline-schedule knobs.

    ``schedule`` picks how micro-batch work is ordered: ``gpipe``
    (all forwards, then all backwards), ``1f1b`` (after a warmup each
    stage alternates one backward with one forward), or ``zero_bubble``
    (backward split into an input-gradient tick and a deferred
    weight-gradient pass). ``virtual_pp_degree`` is the interleaving
    factor V: chunk c of the layer stack lives on physical stage c % S."""

    schedule: str = "gpipe"
    virtual_pp_degree: int = 1


def _strategy_pp_config(strategy) -> PpScheduleConfig:
    cfg = PpScheduleConfig()
    if strategy is None:
        return cfg
    sub = dict(getattr(strategy, "pipeline_configs", {}) or {})
    sched = str(sub.get("schedule", cfg.schedule)).strip().lower()
    if sched not in PP_SCHEDULES:
        raise ValueError(
            f"pipeline_configs.schedule={sched!r} not in {PP_SCHEDULES}")
    v = max(int(sub.get("virtual_pp_degree", cfg.virtual_pp_degree)), 1)
    return PpScheduleConfig(schedule=sched, virtual_pp_degree=v)


def resolve_pp_schedule(strategy=None) -> PpScheduleConfig:
    """Strategy knobs overridden by ``PADDLE_TPU_PP_SCHEDULE``.

    Env grammar (case-insensitive), mirroring PADDLE_TPU_GRAD_COMM:
      ``gpipe`` / ``1f1b`` / ``zero_bubble``   bare schedule tokens
      comma list of ``k=v``                    ``schedule=1f1b,virtual=2``
                                               (``vpp`` / ``virtual_pp_degree``
                                               are aliases of ``virtual``)
      bare tokens compose with k=v ones:       ``zero_bubble,virtual=2``
    """
    if strategy is None:
        from .. import fleet_strategy

        strategy = fleet_strategy()
    cfg = _strategy_pp_config(strategy)
    raw_env = os.environ.get("PADDLE_TPU_PP_SCHEDULE", "").strip().lower()
    if not raw_env:
        return cfg
    for part in raw_env.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            if part in PP_SCHEDULES:
                cfg = replace(cfg, schedule=part)
            else:
                raise ValueError(
                    f"PADDLE_TPU_PP_SCHEDULE: bad token {part!r} "
                    f"(want k=v or a schedule from {PP_SCHEDULES})")
            continue
        k, v = (s.strip() for s in part.split("=", 1))
        if k == "schedule":
            if v not in PP_SCHEDULES:
                raise ValueError(
                    f"PADDLE_TPU_PP_SCHEDULE schedule={v!r} not in "
                    f"{PP_SCHEDULES}")
            cfg = replace(cfg, schedule=v)
        elif k in ("virtual", "vpp", "virtual_pp_degree"):
            cfg = replace(cfg, virtual_pp_degree=max(int(v), 1))
        else:
            raise ValueError(f"PADDLE_TPU_PP_SCHEDULE: unknown key {k!r}")
    return cfg


class LayerDesc:
    """Deferred layer construction (reference: pp_layers.LayerDesc)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> torch.nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Weight-shared layer (e.g. tied embedding / head): every desc with
    the same ``key`` is the same layer object, replicated on every pipe
    rank, its gradients summed over the pipe group."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _primitive(v):
    return isinstance(v, (bool, int, float, str, type(None)))


def _cfg_sig(layer):
    """Primitive / callable config fingerprint: Dropout(p=0.1) and
    Dropout(p=0.5), or wrappers of different forward functions, must not
    fold together (a benign difference merely prevents folding)."""
    out = []
    for k, v in sorted(vars(layer).items()):
        if k == "training":
            continue
        if _primitive(v):
            out.append((k, v))
        elif isinstance(v, (tuple, list)) and all(_primitive(i) for i in v):
            out.append((k, tuple(v)))
        elif isinstance(v, dict) and all(_primitive(i) for i in v.values()):
            out.append((k, tuple(sorted(v.items()))))
        elif callable(v) and not isinstance(v, (torch.nn.Module,
                                                torch.Tensor)):
            out.append((k, getattr(v, "__qualname__", type(v).__name__)))
    return tuple(out)


def _type_sig(layer):
    """Recursive structural identity: type chain and each layer's config
    fingerprint (folding runs every block through the same code)."""
    return (type(layer).__name__, _cfg_sig(layer),
            tuple(_type_sig(m) for m in layer._modules.values()
                  if m is not None))


def _param_sig(layer):
    return (_type_sig(layer),) + tuple(
        (n, tuple(p.shape), str(p.dtype))
        for n, p in layer.named_parameters()) + tuple(
        (n, tuple(b.shape), str(b.dtype)) for n, b in layer.named_buffers())


def _pipe_degree() -> int:
    hcg = get_hybrid_communicate_group()
    return hcg.get_pipe_parallel_world_size() if hcg is not None else 1


def is_pipeline_local(p) -> bool:
    """Whether ``p`` belongs to this rank's stage of a pipelined stack
    (else it is replicated on every pipe rank)."""
    return pipeline_slot(p) is not None


def pipeline_slot(p):
    """``(stack, local block, position in the block)`` of a parameter of
    this rank's stage of a pipelined stack, else None."""
    return p.__dict__.get("pipeline_slot")


class SpmdPipeline(Layer):
    """Stack of identical blocks, split over the pipe ranks (see the
    module docstring). ``num_stages`` defaults to the hybrid group's pipe
    degree; the stack runs pipelined when that group's pipe degree equals
    it, else (no group, or another degree) it is the fold on one rank, as
    the reference's stack is without a ``pp`` mesh axis."""

    def __init__(
        self,
        blocks: Sequence[torch.nn.Module],
        num_stages: Optional[int] = None,
        num_microbatches: Optional[int] = None,
        recompute_block: bool = False,
        num_virtual_stages: Optional[int] = None,
        recompute_granularity: str = "full",
        schedule: Optional[str] = None,
    ):
        super().__init__()
        blocks = list(blocks)
        if not blocks:
            raise ValueError("SpmdPipeline needs at least one block")
        sig = _param_sig(blocks[0])
        for b in blocks[1:]:
            if _param_sig(b) != sig:
                raise ValueError(
                    "SpmdPipeline blocks must be structurally identical")
        self.num_layers = len(blocks)
        self.num_stages = num_stages or _pipe_degree()
        if schedule is not None and schedule not in PP_SCHEDULES:
            raise ValueError(f"schedule={schedule!r} not in {PP_SCHEDULES}")
        # None = resolve at run time (strategy / env may change per run)
        self._schedule = schedule
        if num_virtual_stages is None:
            # unset: adopt the strategy / env virtual degree when it
            # divides the stack, else non-interleaved (an explicit
            # argument keeps the hard error below)
            s_eff = max(self.num_stages, 1)
            v = resolve_pp_schedule().virtual_pp_degree if s_eff > 1 else 1
            if v > 1 and self.num_layers % (s_eff * v) != 0:
                warnings.warn(
                    f"virtual_pp_degree={v} does not divide "
                    f"{self.num_layers} layers over {s_eff} stages; "
                    "falling back to non-interleaved pipeline",
                    stacklevel=2)
                v = 1
            num_virtual_stages = v
        self.num_virtual_stages = max(int(num_virtual_stages), 1)
        n_chunks = max(self.num_stages, 1) * self.num_virtual_stages
        if self.num_layers % n_chunks != 0:
            raise ValueError(
                f"{self.num_layers} layers not divisible by {self.num_stages} "
                f"stages x {self.num_virtual_stages} virtual stages")
        self.num_microbatches = num_microbatches
        self.recompute_block = recompute_block
        policy_for_granularity(recompute_granularity)  # fail fast on typos
        self.recompute_granularity = recompute_granularity
        # chunk c of the stack lives on stage c % S; the stacked order is
        # stage-major, so stage s's V chunks are one contiguous slice
        S = max(self.num_stages, 1)
        chunk_len = self.num_layers // n_chunks
        order = sorted(
            range(self.num_layers),
            key=lambda l: ((l // chunk_len) % S, (l // chunk_len) // S, l))
        self._layer_order = order
        self._inv_order = np.argsort(order)
        self._chunk_len = chunk_len
        hcg = get_hybrid_communicate_group()
        self.pipelined = (S > 1 and hcg is not None
                          and hcg.get_pipe_parallel_world_size() == S)
        self.stage = hcg.get_stage_id() if self.pipelined else 0
        self._group = (hcg.get_pipe_parallel_group() if self.pipelined
                       else None)
        per = self.num_layers // S if self.pipelined else self.num_layers
        # this rank's blocks, in stacked order (the others are dropped)
        self.blocks = LayerList(blocks[l] for l in
                                order[self.stage * per:(self.stage + 1) * per])
        params = [n for n, _ in blocks[0].named_parameters()]
        if self.pipelined:
            for j, blk in enumerate(self.blocks):
                for k, p in enumerate(blk.parameters()):
                    p.__dict__["pipeline_slot"] = (self, j, k)
        self._block_params = params
        self._leaves = [(n, n.replace(".", "__")) for n in params] + [
            (n, n.replace(".", "__") + "_stacked")
            for n in blocks[0].state_dict() if n not in params]
        self._register_state_dict_hook(SpmdPipeline._stack_state)
        self._register_load_state_dict_pre_hook(self._unstack_state)

    # -- the reference's stacked checkpoint layout ---------------------------
    @staticmethod
    def _stack_state(module, state, prefix, local_metadata):
        n = len(module.blocks)
        for leaf, key in module._leaves:
            vals = [state.pop(f"{prefix}blocks.{i}.{leaf}") for i in range(n)]
            state[prefix + key] = torch.stack([v.detach() for v in vals])

    def _unstack_state(self, state, prefix, local_metadata, strict,
                       missing_keys, unexpected_keys, error_msgs):
        n = len(self.blocks)
        for leaf, key in self._leaves:
            if prefix + key not in state:
                continue
            v = state.pop(prefix + key)
            if v.shape[0] != n:
                error_msgs.append(
                    f"size mismatch for {prefix + key}: {tuple(v.shape)} "
                    f"holds {v.shape[0]} layers, this stage {n}")
                continue
            for i in range(n):
                state[f"{prefix}blocks.{i}.{leaf}"] = v[i]

    def slot_position(self, j, k, stage=None):
        """The position of parameter ``k`` of local block ``j`` of
        ``stage`` (default: this rank's) among the stack's parameters in
        layer order, as the unpipelined stack lists them."""
        stage = self.stage if stage is None else stage
        layer = self._layer_order[stage * len(self.blocks) + j]
        return layer * len(self._block_params) + k

    def stacked_leaves(self):
        """``{state key suffix: a block's parameter or buffer}`` of the
        stacked layout (the block's tensor carries its mp attributes)."""
        first = self.blocks[0].state_dict(keep_vars=True)
        return {key: first[leaf] for leaf, key in self._leaves}

    # -- execution -----------------------------------------------------------
    def _run_block(self, blk, x, *extra):
        if self.recompute_block and not getattr(blk, "_use_recompute", False):
            return recompute(blk, x, *extra,
                             granularity=self.recompute_granularity)
        return blk(x, *extra)

    def run_chunk(self, v, h):
        """Apply this rank's local chunk ``v`` (global chunk ``v * S + s``)."""
        lo = v * self._chunk_len
        for blk in self.blocks[lo:lo + self._chunk_len]:
            h = self._run_block(blk, h)
        return h

    def forward(self, x, *extra):
        """The fold: every block in layer order, ``extra`` (an encoder's
        mask) given to each. Pipelined: one forward op of
        :func:`run_schedule`."""
        if not self.pipelined:
            for l in range(self.num_layers):
                x = self._run_block(self.blocks[int(self._inv_order[l])],
                                    x, *extra)
            return x
        if extra:
            raise NotImplementedError(
                "SpmdPipeline: extra per-call args (attention masks, ...) are "
                "supported on the layer-fold path (num_stages=1) only; the "
                "micro-batch pipeline schedules move a single tensor between "
                "stages — fold the mask into the block input or its buffers")
        if _active is None:
            raise RuntimeError(
                "a pipelined SpmdPipeline runs one micro-batch op at a time "
                "under run_schedule: train through fleet.DistTrainStep or "
                "PipelineParallel.train_batch, evaluate through "
                "PipelineParallel.eval_batch")
        return _active.run(self, x)

    def microbatches(self) -> int:
        """The requested micro-batch count: ``num_microbatches``, else the
        strategy's ``pipeline_configs["accumulate_steps"]`` when above 1
        (upstream Paddle's count; the reference always takes S), else S."""
        if self.num_microbatches:
            return int(self.num_microbatches)
        from .. import fleet_strategy

        st = fleet_strategy()
        acc = int(st.pipeline_configs.get("accumulate_steps", 1)) if st else 1
        return acc if acc > 1 else max(self.num_stages, 1)

    def schedule_info(self, batch_size: int,
                      schedule: Optional[str] = None) -> dict:
        """Step / bubble accounting of the schedule (the reference's, see
        :func:`schedule_info`); the fold reports ``schedule="fold"``."""
        M = _choose_microbatches(batch_size, self.microbatches(), warn=False)
        sched = (schedule or self._schedule
                 or resolve_pp_schedule().schedule)
        S = self.num_stages if self.pipelined else 1
        return schedule_info(S, self.num_virtual_stages, M, sched)


def schedule_info(S: int, V: int, M: int, sched: str) -> dict:
    """The reference's ``SpmdPipeline.schedule_info`` for ``S`` stages,
    ``V`` virtual stages and ``M`` micro-batches.

    Per-step cost in full-stage layer passes: the V=1 gpipe ring does 1.0
    per step, the phased schedule one chunk (1/V) per step;
    ``bubble_fraction`` is the forward idle share per flush. Analytic
    fwd+bwd model, unit costs per micro-batch per full stage: F=1, full
    B=2, input-grad B=1, weight-grad W=1 (per chunk divided by V):
    ``fwd_bwd_total_cost`` / ``analytic_bubble_fraction`` (gpipe and 1f1b
    tie; zero_bubble fills the drain with deferred weight gradients,
    reaching 0 when M >= 2(S-1)/V). ``measured_bubble_fraction`` is the
    idle-cell share of the (stage, tick) table."""
    if S <= 1:
        return {"steps": 1, "step_cost": float(M), "total_cost": float(M),
                "ideal_cost": float(M), "bubble_fraction": 0.0, "M": M,
                "schedule": "fold", "fwd_bwd_total_cost": 3.0 * M,
                "analytic_bubble_fraction": 0.0,
                "measured_bubble_fraction": 0.0,
                "schedule_ticks": M, "act_microbatches": M}
    if sched == "gpipe" and V == 1:
        steps, cost = M + S - 1, 1.0
    else:
        groups = -(-M // S)
        steps, cost = groups * S * V + S - 1, 1.0 / V
    total = steps * cost
    busy = V * M                   # scheduled cells per stage per grid
    ticks = 2 * steps + (busy if sched == "zero_bubble" else 0)
    idle = 2 * (steps - busy)
    fill = (S - 1) / V
    if sched == "zero_bubble":
        fb_total = 3.0 * M + max(0.0, 2.0 * fill - M)
    else:
        fb_total = 3.0 * M + 3.0 * fill
    return {"steps": steps, "step_cost": cost, "total_cost": total,
            "ideal_cost": float(M), "bubble_fraction": 1.0 - M / total,
            "M": M, "schedule": sched,
            "fwd_bwd_total_cost": fb_total,
            "analytic_bubble_fraction": 1.0 - 3.0 * M / fb_total,
            "measured_bubble_fraction": idle / ticks,
            "schedule_ticks": ticks,
            "act_microbatches": busy}


def fold_or_list(blocks, fold: bool, recompute: bool = False,
                 recompute_granularity: str = "full"):
    """Model-zoo construction helper: the fold (a one-stage
    :class:`SpmdPipeline`, the reference's stacked checkpoint layout) when
    ``fold``, else a plain ``LayerList``. One definition for GPT, Llama,
    BERT and ERNIE."""
    if fold and len(blocks) > 1:
        return SpmdPipeline(blocks, num_stages=1, recompute_block=recompute,
                            recompute_granularity=recompute_granularity)
    return LayerList(blocks)


def run_stack(stack, x, *extra):
    """Apply a :func:`fold_or_list` stack (or a pipelined one); ``extra``
    (e.g. an encoder's attention mask) goes to every block."""
    if isinstance(stack, SpmdPipeline):
        return stack(x, *extra)
    for blk in stack:
        x = blk(x, *extra) if extra else blk(x)
    return x


def _choose_microbatches(batch: int, requested: int, warn: bool = True) -> int:
    """Largest micro-batch count <= requested that divides the batch,
    warning when it is not the one requested."""
    m = max(1, min(int(requested), int(batch)))
    while batch % m != 0:
        m -= 1
    if warn and m != requested:
        warnings.warn(
            f"num_microbatches={requested} does not divide batch={batch}; "
            f"using {m} micro-batches instead (pipeline bubble grows — pad "
            "the batch or pick a divisor)",
            stacklevel=3,
        )
    return m


def phased_stage_table(S: int, V: int, M: int, schedule: str = "1f1b"):
    """Per stage, the ordered list of ``(tick, kind, mb_idx, chunk)`` ops of
    the phased schedule, ``kind`` ``"F"`` or ``"B"`` (the reference's
    host-side mirror of its compiled schedule decode, which its MPMD
    runner replays, as :func:`run_schedule` does). ``chunk`` is the
    stage's local chunk ``v``: global chunk ``v * S + s``.

    * ``gpipe`` / default phased order: backward ops in reverse tick
      order;
    * ``1f1b`` at V = 1: after a warmup of ``min(M, S - s)`` forwards,
      stage s alternates one backward (ascending micro-batch) with one
      forward, capping the micro-batches in flight at ``S - s``.

    Both orders accumulate the same gradient sum (reassociation only)."""
    if schedule not in PP_SCHEDULES:
        raise ValueError(f"schedule={schedule!r} not in {PP_SCHEDULES}")
    groups = -(-M // S)
    n_steps = groups * S * V + S - 1
    fwd = {s: [] for s in range(S)}
    for t in range(n_steps):
        for s in range(S):
            rel_total = t - s
            if rel_total < 0:
                continue
            g = rel_total // (S * V)
            rel = rel_total - g * S * V
            k_raw = rel // S
            m_local = rel % S
            if g >= groups or g * S + m_local >= M or k_raw >= V:
                continue
            fwd[s].append((t, "F", g * S + m_local, k_raw))
    table = {}
    for s in range(S):
        f_ops = fwd[s]
        b_ops = [(2 * n_steps - 1 - t, "B", mb, k)
                 for (t, _, mb, k) in reversed(f_ops)]
        if schedule == "1f1b" and V == 1:
            # warmup then strict 1B1F, backward ascending by micro-batch
            w = min(M, S - s)
            b_asc = sorted(b_ops, key=lambda op: op[2])
            ops, fi, bi = list(f_ops[:w]), w, 0
            while bi < len(b_asc):
                ops.append(b_asc[bi])
                bi += 1
                if fi < len(f_ops):
                    ops.append(f_ops[fi])
                    fi += 1
            table[s] = ops
        else:
            table[s] = f_ops + b_ops
    return table


# --------------------------------------------- the per-rank schedule runner --
class _StageDone(Exception):
    """Ends a micro-batch's forward on a stage that does not hold the last
    chunk: the rest of the loss function belongs to a later stage."""


#: the forward op the running loss function belongs to (None outside one)
_active = None


class _ForwardOp:
    """One forward op: local chunk ``v`` (global ``c``) of a micro-batch."""

    def __init__(self, p2p, v, c, last, grad):
        self.p2p, self.v, self.c, self.last, self.grad = p2p, v, c, last, grad
        self.inp = self.out = None

    def run(self, pipe, x):
        if self.out is not None:
            raise RuntimeError("the loss function ran the pipelined stack "
                               "twice in one micro-batch")
        inp = x
        if self.c > 0:
            inp = self.p2p.recv_forward(x)
            inp.requires_grad_(self.grad)
        out = pipe.run_chunk(self.v, inp)
        if out.shape != x.shape or out.dtype != x.dtype:
            raise RuntimeError(
                f"a pipelined chunk must keep its input's shape and dtype "
                f"({tuple(x.shape)} {x.dtype} -> {tuple(out.shape)} "
                f"{out.dtype}): the next stage receives into that shape")
        self.inp, self.out = inp, out
        if self.c == self.last:
            return out
        self.p2p.send_forward(out)
        raise _StageDone


@contextlib.contextmanager
def _running(op):
    global _active
    prev, _active = _active, op
    try:
        yield
    finally:
        _active = prev


def pipelined_stack(model) -> Optional[SpmdPipeline]:
    """The pipelined :class:`SpmdPipeline` inside ``model``, or None."""
    found = [m for m in model.modules()
             if isinstance(m, SpmdPipeline) and m.pipelined]
    if len(found) > 1:
        raise NotImplementedError(
            "a model with two pipelined stacks is not ported yet, see "
            "ROADMAP.md §A.7")
    return found[0] if found else None


def _split_microbatches(args, B, M):
    """Each tensor argument whose first dim is the batch's ``B``, cut into
    M equal parts along it; any other argument given whole to each."""
    out = [[] for _ in range(M)]
    for a in args:
        if isinstance(a, torch.Tensor) and a.dim() > 0 and a.shape[0] == B:
            for m, part in enumerate(a.split(B // M)):
                out[m].append(part)
        else:
            for m in range(M):
                out[m].append(a)
    return out


def run_schedule(pipe: SpmdPipeline, model, loss_fn: Callable, args,
                 trained: Optional[List[torch.Tensor]]):
    """Replay this rank's row of the schedule on ``args`` (the batch this
    rank trains on). ``trained`` (the parameters to differentiate) None
    runs the forward ops only, without autograd. Returns ``(results,
    counts)`` on the last stage (what ``loss_fn`` returned per
    micro-batch, and the denominators each recorded), ``([], [])``
    elsewhere; the gradients are left in ``.grad`` of ``trained``."""
    S, V, s = pipe.num_stages, pipe.num_virtual_stages, pipe.stage
    B = next(a.shape[0] for a in args
             if isinstance(a, torch.Tensor) and a.dim() > 0)
    M = _choose_microbatches(B, pipe.microbatches())
    mbs = _split_microbatches(args, B, M)
    sched = pipe._schedule or resolve_pp_schedule().schedule
    train = trained is not None
    zero_bubble = train and sched == "zero_bubble"
    p2p = P2pHelper(pipe._group, s, S)
    last = S * V - 1
    # ZeRO-3: one forward scope a micro-batch, closed when its forward ends
    # (on a stage that hands on, by _StageDone): no gathered weight lives on
    # into another op, and a backward op gathers what it reads again
    scope = (_z3.forward_scope if _z3.is_zero3_model(model)
             else contextlib.nullcontext)
    stash, deferred, results, mb_counts = {}, [], [], []
    for _, kind, mb, v in phased_stage_table(S, V, M, sched)[s]:
        c = v * S + s
        if kind == "F":
            op = _ForwardOp(p2p, v, c, last, train)
            with _running(op), _loss.micro_batch() as recorded, \
                    torch.set_grad_enabled(train), scope():
                try:
                    res = loss_fn(model, *mbs[mb])
                except _StageDone:
                    res = None
            if op.out is None:
                raise RuntimeError("the loss function did not run the "
                                   "pipelined stack")
            counts["forward_ops"] += 1
            if c == last:
                results.append(res)
                mb_counts.append(recorded)
            if train:
                stash[mb, v] = (op.inp if c > 0 else None,
                                res if c == last else op.out)
        elif train:
            inp, out = stash.pop((mb, v))
            dy = None if c == last else p2p.recv_backward(out)
            counts["backward_ops"] += 1
            if zero_bubble:
                # the input's gradient now, the weights' after the drain
                if inp is not None:
                    (dx,) = torch.autograd.grad(out, inp, dy,
                                                retain_graph=True)
                    p2p.send_backward(dx)
                deferred.append((out, dy))
            else:
                torch.autograd.backward(
                    out, dy, inputs=trained + ([inp] if inp is not None
                                               else []))
                if inp is not None:
                    p2p.send_backward(inp.grad)
    for out, dy in deferred:
        torch.autograd.backward(out, dy, inputs=trained)
    p2p.wait_sends()
    return results, mb_counts


def reduce_loss(pipe: SpmdPipeline, results, mb_counts, data_group=None):
    """``(loss, divisor)`` on every pipe rank: the last stage's sum of the
    micro-batch losses over the divisor, broadcast over the pipe group.
    With recorded counts (a masked mean) the divisor is their total (over
    ``data_group`` too, whose ranks split the batch, each then reporting
    ``n`` times its share as ``DistTrainStep`` expects), at least 1; with
    none (per-micro-batch means) it is the number of micro-batches."""
    dev = next(pipe.parameters()).device
    stats = torch.zeros(2, dtype=torch.float32, device=dev)
    if results:
        stats[0] = sum(r.detach().float() for r in results)
        if any(mb_counts):
            if not all(mb_counts):
                raise RuntimeError("the loss recorded a count in some "
                                   "micro-batches only")
            total = sum(c.detach().float().sum()
                        for cs in mb_counts for c in cs)
            n = 1
            if data_group is not None:
                C.all_reduce(total, group=data_group)
                n = data_group.nranks
            stats[1] = torch.clamp(total, min=1.0) / n
        else:
            stats[1] = len(results)
    C.broadcast(stats, src=pipe._group.ranks[-1], group=pipe._group)
    return stats[0] / stats[1], stats[1]


def forward_backward(pipe: SpmdPipeline, model, loss_fn, args, trained,
                     data_group=None):
    """One pipelined forward and backward of ``loss_fn(model, *args)``:
    returns the loss (as :func:`reduce_loss`) and the gradients of
    ``trained``, the replicated parameters' summed over the pipe group,
    all divided by the divisor; this rank's stage-local parameters that
    got none stay None."""
    for p in trained:
        p.grad = None
    results, mb_counts = run_schedule(pipe, model, loss_fn, args, trained)
    loss, divisor = reduce_loss(pipe, results, mb_counts, data_group)
    grads = []
    for p in trained:
        g = p.grad
        if g is None and not is_pipeline_local(p):
            g = torch.zeros_like(p)
        grads.append(g)
        p.grad = None
    rep = [g for p, g in zip(trained, grads) if not is_pipeline_local(p)]
    nbytes = sum(g.numel() * g.element_size() for g in rep)
    if rep:
        # one bucket: the replicated gradients stay bit-equal on the ranks
        grad_comm.allreduce_sum(rep, pipe._group,
                                bucket_mb=nbytes / 2 ** 20)
        counts["replicated_grad_bytes"] += nbytes
    for g in grads:
        if g is not None:
            g.div_(divisor)
    return loss, grads


# ------------------------------------------------------------ PipelineLayer --
class PipelineLayer(Layer):
    """paddle PipelineLayer parity: a LayerDesc list, its longest
    homogeneous run folded into a :class:`SpmdPipeline` over
    ``num_stages`` (default: the pipe degree), the layers around it
    replicated on every pipe rank (only stage 0's output of those before
    it, and the last stage's of those after it, are used)."""

    def __init__(
        self,
        layers: Sequence,
        num_stages: Optional[int] = None,
        topology=None,
        loss_fn: Optional[Callable] = None,
        seg_method: str = "uniform",
        recompute_interval: int = 0,
        recompute_granularity: str = "full",
        num_virtual_pipeline_stages: Optional[int] = None,
        **kwargs,
    ):
        super().__init__()
        self._loss_fn = loss_fn
        self.num_stages = num_stages or _pipe_degree()
        built = []
        self._shared = {}
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                first = d.layer_name not in self._shared
                if first:
                    self._shared[d.layer_name] = d.build_layer()
                layer = self._shared[d.layer_name]
                if d.forward_func is not None or not first:
                    # registered at its first use only: its state is
                    # under one name, as in the reference
                    layer = _ForwardWrapper(layer, d.forward_func, first)
                built.append(layer)
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif isinstance(d, torch.nn.Module):
                built.append(d)
            elif callable(d):
                built.append(_FnLayer(d))
            else:
                raise TypeError(f"unsupported pipeline item {d!r}")
        runs = []
        i = 0
        while i < len(built):
            j = i
            if list(built[i].named_parameters()):
                sig = (type(built[i]), _param_sig(built[i]))
                while j + 1 < len(built) and isinstance(
                        built[j + 1], type(built[i])) and (
                        type(built[j + 1]), _param_sig(built[j + 1])) == sig:
                    j += 1
            runs.append((i, j))
            i = j + 1
        segments = []
        n_virtual_req = max(num_virtual_pipeline_stages or 1, 1)
        folded = []
        for lo, hi in runs:
            n_run = hi - lo + 1
            n_virtual = n_virtual_req
            n_chunks = self.num_stages * n_virtual
            if n_virtual > 1 and (n_run < n_chunks or n_run % n_chunks != 0) \
                    and n_run % self.num_stages == 0:
                warnings.warn(
                    f"num_virtual_pipeline_stages={n_virtual} does not "
                    f"divide the {n_run}-block run over "
                    f"{self.num_stages} stages; falling back to "
                    "non-interleaved pipeline for this run")
                n_virtual = 1
                n_chunks = self.num_stages
            if self.num_stages > 1 and n_run >= n_chunks \
                    and n_run % n_chunks == 0:
                pipe = SpmdPipeline(
                    built[lo:hi + 1], num_stages=self.num_stages,
                    recompute_block=recompute_interval > 0,
                    recompute_granularity=recompute_granularity,
                    num_virtual_stages=n_virtual)
                if pipe.pipelined and any(f.pipelined for f in folded):
                    raise NotImplementedError(
                        "PipelineLayer: a second homogeneous layer run "
                        "pipelined at pp > 1 is not ported yet, see "
                        "ROADMAP.md §A.7 (two pipelined stacks)")
                segments.append(pipe)
                folded.append(pipe)
            else:
                segments.extend(built[lo:hi + 1])
        if self.num_stages > 1 and not folded:
            warnings.warn(
                f"no homogeneous layer run divides {self.num_stages} "
                "pipeline stages; the model runs WITHOUT pipeline "
                "partitioning")
        self._segments = segments
        for i, l in enumerate(segments):
            self.add_sublayer(f"seg_{i}", l)

    def forward(self, x):
        for l in self._segments:
            x = l(x)
        return x


class _FnLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *a, **k):
        return self._fn(*a, **k)


class _ForwardWrapper(Layer):
    """A shared layer's use through its desc's ``forward_func`` (or a
    later plain use); ``owner`` registers the layer as ``inner``."""

    def __init__(self, layer, fn, owner=True):
        super().__init__()
        if owner:
            self.inner = layer
        else:
            self._shared_inner = (layer,)
        self._fn = fn

    def forward(self, *a, **k):
        inner = self.inner if "inner" in self._modules \
            else self._shared_inner[0]
        return self._fn(inner, *a, **k) if self._fn else inner(*a, **k)


class PipelineParallel(Layer):
    """fleet.meta_parallel.PipelineParallel parity: ``train_batch`` and
    ``eval_batch`` over a :class:`PipelineLayer`."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._step_cache = {}

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipelined training step over ``data = (inputs, labels)``
        through ``fleet.DistTrainStep``; returns the loss. A loss scaler
        is not ported (ROADMAP.md §A.7): the reference accepts and ignores
        one."""
        from .. import DistTrainStep

        if scaler is not None:
            raise NotImplementedError(
                "PipelineParallel.train_batch(scaler=...) is not ported "
                "yet, see ROADMAP.md §A.7")
        x, y = data
        loss_fn = getattr(self._layers, "_loss_fn", None)
        if loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for train_batch")
        step = self._step_cache.get(id(optimizer))
        if step is None:
            def compute_loss(model, xb, yb):
                return loss_fn(model(xb), yb)

            step = DistTrainStep(self._layers, compute_loss, optimizer)
            self._step_cache[id(optimizer)] = step
        loss = step(x, y)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The loss of ``data = (inputs, labels)`` (every pipe rank), or
        without ``compute_loss`` the outputs (the last stage; None on the
        others when pipelined)."""
        x, y = data
        loss_fn = getattr(self._layers, "_loss_fn", None)
        pipe = pipelined_stack(self._layers)
        with torch.no_grad():
            if pipe is None:
                out = self._layers(x)
                if compute_loss and loss_fn is not None:
                    return loss_fn(out, y)
                return out
            if compute_loss and loss_fn is not None:
                results, mb_counts = run_schedule(
                    pipe, self._layers, lambda m, a, b: loss_fn(m(a), b),
                    [x, y], None)
                return reduce_loss(pipe, results, mb_counts)[0]
            results, _ = run_schedule(pipe, self._layers,
                                      lambda m, a: m(a), [x], None)
            return torch.cat(results) if results else None

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


__all__ = ["LayerDesc", "PP_SCHEDULES", "PipelineLayer", "PipelineParallel",
           "PpScheduleConfig", "SharedLayerDesc", "SpmdPipeline",
           "counts", "fold_or_list", "forward_backward", "is_pipeline_local",
           "phased_stage_table", "pipeline_slot", "pipelined_stack",
           "reduce_loss", "reset_counts", "resolve_pp_schedule",
           "run_schedule", "run_stack", "schedule_info"]
