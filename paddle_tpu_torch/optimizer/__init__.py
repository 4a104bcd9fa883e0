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

``multi_precision`` (every optimizer here) keeps, for each low-precision
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
parameter's dtype and its f32 master: ROADMAP.md C.8.) ``state_dict``
holds the moments by parameter position and, with a scheduler, its state
under ``"LR_Scheduler"``.

A parameter made with a ``ParamAttr`` (``nn/layer.py``) carries its own
rate factor, ``optimize_attr["learning_rate"]``: its update takes ``lr``
times that factor, in f32 as the reference's ``functional_update`` forms
it; and its own ``regularizer``, applied in place of the optimizer's.

Difference kept on purpose: like the reference's functional path, AdamW
decays every parameter; ``apply_decay_param_fun`` is accepted and not
applied (only the reference's eager ``step`` honours it).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import lr
from .lr import LRScheduler


class ClipGradByGlobalNorm:
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
        pg = [(p, p.grad if p.requires_grad else None)
              for p in self._parameter_list]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        lr = float(np.float32(self.get_lr()))
        for i, (p, g) in enumerate(pg):
            if g is None:
                continue
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
            self._rule(w, g, self._accumulators[i], _param_lr(p, lr))
            if w is not p:
                p.copy_(w)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    def state_dict(self):
        """``{"param_{i}.{state}": tensor}`` (copies) for every parameter
        that has state, and the scheduler's state under ``"LR_Scheduler"``."""
        out = {f"param_{i}.{k}": v.clone()
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
            st = self._init_state(p)
            keys = [k for k in st if f"param_{i}.{k}" in state]
            for k in keys:
                st[k] = state[f"param_{i}.{k}"].to(st[k].device).clone()
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


__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "L1Decay", "L2Decay",
           "Momentum", "Optimizer", "SGD", "lr"]
