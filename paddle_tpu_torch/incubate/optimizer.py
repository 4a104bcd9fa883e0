"""``paddle.incubate.optimizer``'s ``LookAhead`` and ``ModelAverage``
(counterpart of ``paddle_tpu/incubate/optimizer.py``): wrappers around an
optimizer's step, their arithmetic on the parameters' f32 copies on the
parameters' device."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """Lookahead (Zhang et al. 2019): every ``k`` steps of the inner
    optimizer, the slow weights move ``alpha`` toward the fast ones and the
    fast weights are set to them. The slow weights start as f32 copies of
    the parameters when the wrapper is made. Under ``multi_precision`` the
    inner optimizer's f32 master is the fast weight read and set."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if inner_optimizer is None:
            raise ValueError("inner_optimizer can not be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be within [0, 1], got {alpha}")
        if not (isinstance(k, int) and k > 0):
            raise ValueError(f"k must be a positive integer, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._global_step = 0
        self._slow = {i: p.detach().float().clone()
                      for i, p in enumerate(self._parameter_list)
                      if p.requires_grad}

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._global_step += 1
        if self._global_step % self.k:
            return
        masters = getattr(self.inner_optimizer, "_master", {})
        for i, p in enumerate(self._parameter_list):
            if not p.requires_grad:
                continue
            fast = masters.get(i, p).float()
            slow = self._slow.get(i)
            if slow is None:  # made trainable after the wrap
                slow = self._slow[i] = fast.clone()
            slow.add_(self.alpha * (fast - slow))
            p.copy_(slow)
            if i in masters:  # the master follows, or the next step
                masters[i].copy_(slow)  # would bring the fast weight back

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        state = self.inner_optimizer.state_dict()
        state["@lookahead_step"] = self._global_step
        for i, s in self._slow.items():
            state[f"@lookahead_slow_{i}"] = s.clone()
        return state

    def set_state_dict(self, state):
        state = dict(state)
        self._global_step = int(state.pop("@lookahead_step", 0))
        params = self._parameter_list
        self._slow = {}
        for key in [k for k in state if k.startswith("@lookahead_slow_")]:
            i = int(key.rsplit("_", 1)[1])
            self._slow[i] = torch.as_tensor(state.pop(key)).to(
                params[i].device, torch.float32).clone()
        self.inner_optimizer.set_state_dict(state)


class ModelAverage:
    """Parameter averaging over a sliding window: ``step()`` after each
    optimizer step adds the parameters (f32) to the open window's sum; when
    the window (``average_window_rate`` times the steps, clamped to
    ``[min_average_window, max_average_window]``) is full it becomes the
    closed one and a new one opens. The average spans the closed and the
    open window. ``with apply():`` sets the parameters to it, and
    ``restore()`` (on leaving, unless ``need_restore=False``) back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameter_list = list(parameters)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        n = len(self._parameter_list)
        self._sum_1 = [None] * n  # the open window
        self._sum_3 = [None] * n  # the last closed one
        self._num_accumulates = 0
        self._old_num_accumulates = 0
        self._num_updates = 0
        self._restore = None

    @torch.no_grad()
    def step(self):
        self._num_updates += 1
        window = max(self.min_average_window,
                     min(self.max_average_window,
                         int(self._num_updates * self.average_window)))
        if self._num_accumulates >= window:
            self._sum_3 = self._sum_1
            self._sum_1 = [None] * len(self._parameter_list)
            self._old_num_accumulates = self._num_accumulates
            self._num_accumulates = 0
        for i, p in enumerate(self._parameter_list):
            v = p.detach().float()
            if self._sum_1[i] is None:
                self._sum_1[i] = v.clone()
            else:
                self._sum_1[i].add_(v)
        self._num_accumulates += 1

    def _average(self, i):
        parts = [s for s in (self._sum_1[i], self._sum_3[i]) if s is not None]
        count = self._num_accumulates + self._old_num_accumulates
        if not parts or count == 0:
            return None
        total = parts[0] if len(parts) == 1 else parts[0] + parts[1]
        return total / count

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """Within: every parameter is its average. With ``need_restore=
        False`` it stays so on leaving, and ``restore()`` still works."""
        if self._restore is not None:
            raise RuntimeError("ModelAverage.apply() calls cannot nest")
        saved = []
        with torch.no_grad():
            for i, p in enumerate(self._parameter_list):
                saved.append(p.detach().clone())
                avg = self._average(i)
                if avg is not None:
                    p.copy_(avg)
        self._restore = saved
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._restore is None:
            return
        for p, v in zip(self._parameter_list, self._restore):
            p.copy_(v)
        self._restore = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The reference's: accumulates (``step``); the loss is not read."""
        self.step()
