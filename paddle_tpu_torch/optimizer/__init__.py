"""Optimizers (counterpart of ``paddle_tpu/optimizer/__init__.py``).

``Optimizer`` / ``SGD`` / ``Momentum`` / ``Adam`` / ``AdamW`` with
``ClipGradByGlobalNorm``, ``L2Decay`` and ``L1Decay``, applied in the
order the reference's functional step (the one ``TrainStep`` runs)
applies them: global-norm clip over all gradients,
then per parameter the regularizer, then the update rule. Updates run in
place under ``torch.no_grad()`` as plain tensor ops, the reference's plain
jnp that XLA fuses; no kernel is called for. State lives on each
parameter's device, ``beta1_pow`` / ``beta2_pow`` as f32 scalars there, so
a step never waits on the host.

``multi_precision`` (where the reference has it) keeps, for each low-precision
parameter, an f32 master copy and f32 state, as the reference's eager
``step`` does under ``_use_master_weights``: the gradient is read as f32,
the regularizer, AdamW's decay and the Adam update act on the master, and
the master is then written into the parameter in its dtype. An update
below half an ulp of the parameter's dtype so still accumulates. The
masters are not in ``state_dict`` (as the reference's); after a reload
each is taken again from its parameter.

The learning rate is a float or an ``lr.LRScheduler``; ``step`` takes it
rounded to f32, as the reference's ``TrainStep`` passes it to the update
(``jnp.asarray(get_lr(), jnp.float32)``), and forms AdamW's decay factor
``1 - lr * wd`` in f32 as the reference's jnp does. (There, that f32
factor promotes a bf16 parameter to f32 for good; the port keeps each
parameter's dtype and its f32 master: ROADMAP.md C.8.) With a scheduler,
``state_dict`` holds its state under ``"LR_Scheduler"``.

A parameter made with a ``ParamAttr`` (``nn/layer.py``) carries its own
rate factor, ``optimize_attr["learning_rate"]``: its update takes ``lr``
times that factor, in f32 as the reference's ``functional_update`` forms
it; and its own ``regularizer``, applied in place of the optimizer's.

Difference kept on purpose: like the reference's functional path, AdamW
decays every parameter; ``apply_decay_param_fun`` is accepted and not
applied (only the reference's eager ``step`` honours it).

The other rules (``Adagrad``, ``Adamax``, ``RMSProp``, ``Adadelta``,
``ASGD``, ``Rprop``, ``NAdam``, ``RAdam``, ``Lamb``, ``Lars``) transcribe
the reference's arithmetic term by term; none wraps ``torch.optim``, whose
formulas differ (RMSProp's epsilon inside the root, NAdam's momentum
schedule, RAdam's switch, Rprop's dropped sign flips). Every scalar of the
state is a tensor on the parameter's device and every branch on it a
``torch.where``, so no rule waits on the host. Lamb's and Lars's trust
ratios take the norms of the *whole* parameter: under fleet a parameter
split over ranks (an mp shard, a ZeRO-3 slice, an expert slice) has its
squares summed over the split's group first (``_sq_sums``, the hook
``_split_sum`` that ``fleet.HybridParallelOptimizer`` sets), as the
reference's one program over the logical arrays does. ``LBFGS`` is the
reference's procedure (one two-loop direction, then a backtracking Armijo
search), not torch's.

``state_dict`` keys each entry ``f"{name}.{state}"``, ``name`` the
parameter's ``ParamAttr`` name or ``param_{i}`` by position, as the
reference keys it; a state entry that is not a tensor (Lamb's and Lars's
exclusion markers) is saved as the reference saves it, an empty array.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import lr
from .lr import LRScheduler


class ClipGradBase:
    """A gradient clip: called with the ``(parameter, gradient or None)``
    pairs, returns them clipped."""

    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``), in place."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                g.clamp_(self.min, self.max)
        return params_grads


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip / max(n, 1e-12), 1)``, ``n`` its
    own L2 norm in its dtype (the reference's formula; torch's
    ``clip_grad_norm_`` adds its epsilon elsewhere), in place.
    ``split_sum(p, squares)``, when given (fleet's), sums a split
    parameter's squares over the ranks holding its other parts, so ``n``
    is the whole gradient's norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads, split_sum=None):
        for p, g in params_grads:
            if g is None:
                continue
            sq = torch.sum(torch.square(g)).reshape(1)
            if split_sum is not None:
                split_sum(p, sq)
            n = torch.sqrt(sq[0])
            g.mul_(torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                               max=1.0))
        return params_grads


class ClipGradByGlobalNorm(ClipGradBase):
    """``g * clip / max(gnorm, clip)`` with the global norm taken in f32
    over every gradient present. The gradients are scaled in place (each
    rounded to its dtype, as the reference's ``astype``), so no second copy
    of them is held during the step; the pairs are returned."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq = [torch.sum(torch.square(g.float()))
              for _, g in params_grads if g is not None]
        if not sq:
            return params_grads
        gnorm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        for _, g in params_grads:
            if g is not None:
                g.mul_(scale)
        return params_grads


class L2Decay:
    """Coupled L2 regularization: ``g + coeff * p``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * p


class L1Decay:
    """Coupled L1 regularization: ``g + coeff * sign(p)``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * torch.sign(p)


def _saved(v):
    """A state entry as ``state_dict`` holds it: a tensor's copy, or (an
    exclusion marker ``()``) an array of it, as the reference saves it."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    return torch.tensor(v, dtype=torch.float32)


def _param_lr(p, lr):
    """``lr`` scaled by the parameter's ``ParamAttr`` learning rate, as an
    f32 product."""
    factor = getattr(p, "optimize_attr", None)
    factor = 1.0 if factor is None else factor.get("learning_rate", 1.0)
    if factor == 1.0:
        return lr
    return float(np.float32(lr) * np.float32(factor))


class Optimizer:
    """Base: holds the parameter list (its order is the state order), the
    learning rate, the regularizer and the grad clip. ``step`` reads each
    parameter's ``.grad``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (list of "
                             "Parameters)")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (float, int)):
            self._regularizer = L2Decay(float(weight_decay))
        else:
            self._regularizer = weight_decay
        self._accumulators: List[Optional[dict]] = (
            [None] * len(self._parameter_list))
        self._multi_precision = False
        self._master = {}  # parameter position -> its f32 master
        # fleet's hook: sums a split parameter's squares over its group
        self._split_sum = None
        self._updating = None  # the parameter ``_rule`` is updating

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr cannot be used with an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _init_state(self, p) -> dict:
        return {}

    def _rule(self, p, g, st, lr):
        """Update ``p`` and ``st`` in place from gradient ``g``."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        self._apply([(p, p.grad if p.requires_grad else None)
                     for p in self._parameter_list])

    def _apply(self, pg):
        """The step from the ``(parameter, gradient or None)`` pairs, in the
        parameter list's order: the clip, then each update."""
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        lr = float(np.float32(self.get_lr()))
        for i, (p, g) in enumerate(pg):
            if g is not None:
                self._update(i, p, g, lr)

    def _update(self, i, p, g, lr):
        """The update of parameter ``i`` (``p``) from its gradient ``g``:
        its state made on first use, the regularizer, then the rule (on
        the f32 master under ``multi_precision``)."""
        if self._accumulators[i] is None:
            self._accumulators[i] = self._init_state(p)
        w = p
        if self._multi_precision and p.dtype != torch.float32:
            w = self._master.get(i)
            if w is None:
                w = self._master[i] = p.float()
        g = g.to(w.dtype)
        reg = getattr(p, "regularizer", None) or self._regularizer
        if reg is not None:
            g = reg(w, g)
        self._updating = p
        self._rule(w, g, self._accumulators[i], _param_lr(p, lr))
        self._updating = None
        if w is not p:
            p.copy_(w)

    def _sq_sums(self, *xs):
        """``[sum(x**2) for x in xs]`` (each in its dtype) as one tensor,
        for the parameter being updated: when it is split over ranks
        (fleet's ``_split_sum``), summed over them, so they are the whole
        parameter's."""
        sq = torch.stack([torch.sum(torch.square(x)) for x in xs])
        if self._split_sum is not None:
            self._split_sum(self._updating, sq)
        return sq

    def _state_name(self, i):
        """The prefix of parameter ``i``'s state keys: its ``ParamAttr``
        name, else ``param_{i}`` (the reference's rule)."""
        return getattr(self._parameter_list[i], "name", None) \
            or f"param_{i}"

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    def state_dict(self):
        """``{f"{name}.{state}": copy}`` (``name`` from ``_state_name``)
        for every parameter that has state, and the scheduler's state under
        ``"LR_Scheduler"``."""
        out = {f"{self._state_name(i)}.{k}": _saved(v)
               for i, st in enumerate(self._accumulators) if st is not None
               for k, v in st.items()}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        self._master.clear()
        sched = state.get("LR_Scheduler")
        if sched and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(sched)
        for i, p in enumerate(self._parameter_list):
            name = self._state_name(i)
            st = self._init_state(p)
            keys = [k for k in st if f"{name}.{k}" in state]
            for k in keys:
                if isinstance(st[k], torch.Tensor):  # a marker stays as is
                    st[k] = torch.as_tensor(state[f"{name}.{k}"]).to(
                        st[k].device).clone()
            if keys:
                self._accumulators[i] = st


class SGD(Optimizer):
    """``p <- p - lr * g``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._multi_precision = bool(multi_precision)

    def _rule(self, p, g, st, lr):
        p.sub_(lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum without dampening (the reference's rule):
    ``v <- mu * v + g``, then ``p <- p - lr * v``, or under Nesterov
    ``p <- p - lr * (g + mu * v)``. A float ``weight_decay`` is an L2
    coefficient folded into the gradient first. The state is
    ``velocity``, in the parameter's dtype (f32 under
    ``multi_precision``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"velocity": torch.zeros_like(p, dtype=dt)}

    def _rule(self, p, g, st, lr):
        mu = self._momentum
        v = st["velocity"].mul_(mu).add_(g)
        if self._nesterov:
            p.sub_(lr * (g + mu * v))
        else:
            p.sub_(lr * v)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"moment1": torch.zeros_like(p, dtype=dt),
                "moment2": torch.zeros_like(p, dtype=dt),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _rule(self, p, g, st, lr):
        """The Adam update of ``p`` in place; ``g`` at ``p``'s dtype, each
        term promoted as the reference's jnp promotes it."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        st["beta1_pow"].mul_(b1)
        st["beta2_pow"].mul_(b2)
        m1 = st["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = st["moment2"].mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m1 / (1 - st["beta1_pow"])
        vhat = m2 / (1 - st["beta2_pow"])
        p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))


class AdamW(Adam):
    """Decoupled weight decay: ``p <- p * (1 - lr * wd)`` before the Adam
    update (reference ``AdamW._rule``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = (float(weight_decay)
                    if isinstance(weight_decay, (int, float)) else 0.01)

    def _rule(self, p, g, st, lr):
        if self._wd:  # the f32 factor; p (or its master) keeps its dtype
            p.mul_(float(np.float32(1.0)
                         - np.float32(lr) * np.float32(self._wd)))
        super()._rule(p, g, st, lr)


def _zeros(p, dtype):
    return torch.zeros_like(p, dtype=dtype)


def _scalar(p, value, dtype=torch.float32):
    """A state scalar on ``p``'s device."""
    return torch.full((), value, dtype=dtype, device=p.device)


class Adagrad(Optimizer):
    """``m <- m + g^2``, ``p <- p - lr * g / (sqrt(m) + eps)``; ``m``
    starts at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _rule(self, p, g, st, lr):
        m = st["moment"].add_(torch.square(g))
        p.sub_(lr * g / (torch.sqrt(m) + self._epsilon))


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u <- max(b2 * u, |g| + eps)``,
    ``p <- p - lr / (1 - b1^t) * m / u``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p),
                "beta1_pow": _scalar(p, 1.0)}

    def _rule(self, p, g, st, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = st["beta1_pow"].mul_(b1)
        m = st["moment"].mul_(b1).add_((1 - b1) * g)
        u = torch.maximum(b2 * st["inf_norm"], torch.abs(g) + eps)
        st["inf_norm"].copy_(u)
        p.sub_((lr / (1 - b1p)) * m / u)


class RMSProp(Optimizer):
    """``ms <- rho * ms + (1 - rho) g^2``; the root takes epsilon inside,
    ``sqrt(ms + eps)`` (centered: ``sqrt(ms - mg^2 + eps)``); ``v <- mu *
    v + lr * g / root``, ``p <- p - v``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p),
              "velocity": torch.zeros_like(p)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p)
        return st

    def _rule(self, p, g, st, lr):
        rho = self._rho
        ms = st["mean_square"].mul_(rho).add_((1 - rho) * torch.square(g))
        if self._centered:
            mg = st["mean_grad"].mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        v = st["velocity"].mul_(self._momentum).add_(lr * g / denom)
        p.sub_(v)


class Adadelta(Optimizer):
    """``E[g^2]`` and ``E[dx^2]`` decayed by ``rho``; ``dx = -sqrt((E[dx^2]
    + eps) / (E[g^2] + eps)) * g``, ``p <- p + lr * dx``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _rule(self, p, g, st, lr):
        rho, eps = self._rho, self._epsilon
        asg = st["avg_squared_grad"].mul_(rho).add_(
            (1 - rho) * torch.square(g))
        asu = st["avg_squared_update"]
        update = -torch.sqrt((asu + eps) / (asg + eps)) * g
        asu.mul_(rho).add_((1 - rho) * torch.square(update))
        p.add_(lr * update)


class ASGD(Optimizer):
    """Averaged gradient over the last ``batch_num`` steps: a ring ``ys``
    of the gradients, ``d`` their sum, ``p <- p - lr * d / m`` with ``m``
    the steps seen, saturating at ``batch_num``. The slot is
    ``step % batch_num`` on the device (an int32 state scalar), read and
    written by index, so the step never syncs. The state is ``batch_num``
    times the parameter's size."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = int(batch_num)
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"d": _zeros(p, dt),
                "ys": torch.zeros((self._batch_num,) + tuple(p.shape),
                                  dtype=dt, device=p.device),
                "step": _scalar(p, 0, torch.int32)}

    def _rule(self, p, g, st, lr):
        n = self._batch_num
        slot = torch.remainder(st["step"], n).reshape(1).long()
        y_old = st["ys"].index_select(0, slot)[0]
        d = st["d"].sub_(y_old).add_(g)
        st["ys"].index_copy_(0, slot, g[None].to(st["ys"].dtype))
        m = torch.clamp(st["step"] + 1, max=n).to(p.dtype)
        p.sub_(lr * d / m)
        st["step"].add_(1)


class Rprop(Optimizer):
    """Resilient backpropagation: per-element step sizes ``lrs`` (seeded
    with the learning rate when the state is made) grow by ``etas[1]``
    while the gradient keeps its sign and shrink by ``etas[0]`` on a flip,
    clamped to ``learning_rate_range``; a flipped element's gradient is
    dropped for the step; ``p <- p - lrs * sign(g)``."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_range = (float(learning_rate_range[0]),
                          float(learning_rate_range[1]))
        self._etas = (float(etas[0]), float(etas[1]))
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"prev_grad": _zeros(p, dt),
                "lrs": torch.full_like(p, float(self.get_lr()), dtype=dt)}

    def _rule(self, p, g, st, lr):
        sign = torch.sign(st["prev_grad"] * g)
        lo, hi = self._lr_range
        neg, pos = self._etas
        lrs = st["lrs"]
        factor = torch.where(sign > 0, pos,
                             torch.where(sign < 0, neg, 1.0)).to(lrs.dtype)
        lrs.copy_(torch.clamp(lrs * factor, lo, hi))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        p.sub_(lrs * torch.sign(g_eff))
        st["prev_grad"].copy_(g_eff)


class NAdam(Optimizer):
    """Adam with Nesterov momentum and Dozat's schedule ``mu_t = b1 * (1 -
    0.5 * 0.96^(t * momentum_decay))``: ``mhat = mu_{t+1} m / (1 - prod mu
    * mu_{t+1}) + (1 - mu_t) g / (1 - prod mu)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = float(momentum_decay)
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"moment1": _zeros(p, dt), "moment2": _zeros(p, dt),
                "mu_product": _scalar(p, 1.0), "beta2_pow": _scalar(p, 1.0),
                "step": _scalar(p, 0.0)}

    def _rule(self, p, g, st, lr):
        b1, b2, eps, psi = self._beta1, self._beta2, self._epsilon, self._psi
        t = st["step"].add_(1.0)
        mu_t = b1 * (1.0 - 0.5 * torch.pow(0.96, t * psi))
        mu_next = b1 * (1.0 - 0.5 * torch.pow(0.96, (t + 1.0) * psi))
        mu_prod = st["mu_product"].mul_(mu_t)
        b2p = st["beta2_pow"].mul_(b2)
        m1 = st["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = st["moment2"].mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = (mu_next * m1 / (1 - mu_prod * mu_next)
                + (1 - mu_t) * g / (1 - mu_prod))
        vhat = m2 / (1 - b2p)
        p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))


class RAdam(Optimizer):
    """Rectified Adam: the adaptive step, scaled by the variance
    rectification, once ``rho_t > 4``, else the bias-corrected momentum
    alone; the switch is a ``torch.where`` on the state scalars."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"moment1": _zeros(p, dt), "moment2": _zeros(p, dt),
                "beta1_pow": _scalar(p, 1.0), "beta2_pow": _scalar(p, 1.0),
                "step": _scalar(p, 0.0)}

    def _rule(self, p, g, st, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = st["step"].add_(1.0)
        b1p = st["beta1_pow"].mul_(b1)
        b2p = st["beta2_pow"].mul_(b2)
        m1 = st["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = st["moment2"].mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m1 / (1 - b1p)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2p / (1.0 - b2p)
        r_num = (rho_t - 4.0) * (rho_t - 2.0) * rho_inf
        r_den = (rho_inf - 4.0) * (rho_inf - 2.0) * rho_t
        rect = torch.sqrt(torch.clamp(r_num, min=0.0)
                          / torch.clamp(r_den, min=eps))
        vhat = torch.sqrt(m2 / (1 - b2p))
        adaptive = rect * mhat / (vhat + eps)
        p.sub_(lr * torch.where(rho_t > 4.0, adaptive, mhat))


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam direction plus decoupled decay,
    ``r = mhat / (sqrt(vhat) + eps) + wd * p``, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0) of the whole parameter
    (``_sq_sums``). A parameter whose name ``exclude_from_weight_decay_fn``
    accepts runs with ``wd = 0`` (its state carries the marker
    ``wd_excluded``, as the reference's)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        st = {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
              "beta1_pow": _scalar(p, 1.0), "beta2_pow": _scalar(p, 1.0)}
        if self._exclude_fn is not None and self._exclude_fn(
                getattr(p, "name", None) or ""):
            st["wd_excluded"] = ()
        return st

    def _rule(self, p, g, st, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = 0.0 if "wd_excluded" in st else self._wd
        b1p = st["beta1_pow"].mul_(b1)
        b2p = st["beta2_pow"].mul_(b2)
        m1 = st["moment1"].mul_(b1).add_((1 - b1) * g)
        m2 = st["moment2"].mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m1 / (1 - b1p)
        vhat = m2 / (1 - b2p)
        r = mhat / (torch.sqrt(vhat) + eps) + wd * p
        w_norm, r_norm = torch.sqrt(self._sq_sums(p, r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        p.sub_(lr * trust * r)


class Lars(Optimizer):
    """LARS momentum: ``local_lr = lr * coeff * |p| / (|g| + wd * |p| +
    eps)`` (``lr`` where ``|p|`` or the denominator is 0), of the whole
    parameter (``_sq_sums``); ``v <- mu * v + local_lr * (g + wd * p)``,
    ``p <- p - v``. A parameter whose name contains a string of
    ``exclude_from_weight_decay`` runs with ``wd = 0`` and keeps its trust
    ratio (the state marker ``excluded``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = float(momentum)
        self._coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        st = {"velocity": _zeros(p, dt)}
        if any(s in (getattr(p, "name", None) or "") for s in self._exclude):
            st["excluded"] = ()
        return st

    def _rule(self, p, g, st, lr):
        wd = 0.0 if "excluded" in st else self._lars_wd
        p_norm, g_norm = torch.sqrt(self._sq_sums(p, g))
        denom = g_norm + wd * p_norm + self._epsilon
        local_lr = torch.where((p_norm > 0) & (denom > 0),
                               lr * self._coeff * p_norm / denom, lr)
        v = st["velocity"].mul_(self._momentum).add_(local_lr * (g + wd * p))
        p.sub_(v)


class LBFGS(Optimizer):
    """L-BFGS as the reference runs it: each ``step(closure)`` evaluates
    the loss, takes one direction from the two-loop recursion over the
    last ``history_size`` curvature pairs, then backtracks (Armijo, up to
    10 halvings from the learning rate) and records the point it reached.
    ``max_iter`` and ``line_search_fn`` are accepted and not used, as in
    the reference. The closure recomputes the loss and its gradients
    (``backward``); the line search reads its losses on the host."""

    def __init__(self, learning_rate=1.0, max_iter=20, tolerance_grad=1e-7,
                 tolerance_change=1e-9, history_size=100, line_search_fn=None,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = max_iter
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s, self._y = [], []
        self._prev_flat = None
        self._prev_grad = None

    def _flat(self, vals):
        return torch.cat([v.reshape(-1) for v in vals])

    def _grads(self):
        return self._flat([p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for p in self._parameter_list])

    def _direction(self, g):
        q = g
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / torch.clamp(torch.dot(y, y),
                                                    min=1e-10))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    def _set_flat(self, flat):
        off = 0
        with torch.no_grad():
            for p in self._parameter_list:
                n = p.numel()
                p.copy_(flat[off:off + n].view_as(p))
                off += n

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning the "
                             "loss")
        loss = closure()
        with torch.no_grad():
            flat = self._flat([p.detach() for p in self._parameter_list])
            g = self._grads()
            if float(torch.max(torch.abs(g))) <= self.tol_grad:
                return loss
            if self._prev_flat is not None:
                s = flat - self._prev_flat
                y = g - self._prev_grad
                if float(torch.dot(s, y)) > 1e-10:
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self.history_size:
                        self._s.pop(0)
                        self._y.pop(0)
            d = self._direction(g)
            f0 = float(loss.detach())
            gtd = float(torch.dot(g, d))
        t = self.get_lr()
        new_flat = flat
        for trial in range(10):  # backtracking Armijo
            new_flat = flat + t * d
            self._set_flat(new_flat)
            self.clear_grad()
            f1 = float(closure().detach())
            if f1 <= f0 + 1e-4 * t * gtd:
                break
            if trial < 9:
                t *= 0.5
        # the point the parameters are at, or the next (s, y) pair is wrong
        self._prev_flat = new_flat
        with torch.no_grad():
            self._prev_grad = self._grads()
        return loss


__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "L1Decay", "L2Decay", "LBFGS", "Lamb", "Lars",
           "Momentum", "NAdam", "Optimizer", "RAdam", "RMSProp", "Rprop",
           "SGD", "lr"]
