"""Training callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

``Callback``, ``CallbackList``, ``config_callbacks``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler`` (steps the
optimizer's ``optimizer/lr.py`` scheduler) and ``ReduceLROnPlateau``, as
in the reference. Its observability callbacks (``VisualDL``,
``TelemetryLogger``, ``WandbCallback``) wait for the port's observability
(ROADMAP.md §A.8).
"""
from __future__ import annotations

import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    # mode-specific no-ops (subclasses override what they need)
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_end(mode, step, logs)


def _items(logs):
    return " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                      if isinstance(v, (int, float)) and k != "batch_size")


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self._t0 = time.time()
        self.epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._steps = 0
        self._epoch_t0 = time.time()
        if self.verbose:
            total = self.params.get("epochs")
            print(f"Epoch {epoch + 1}/{total}")

    def on_train_batch_end(self, step, logs=None):
        self._steps += 1
        if self.verbose and step % self.log_freq == 0:
            steps = self.params.get("steps")
            dt = (time.time() - self._epoch_t0) / max(self._steps, 1)
            print(f"step {step + 1}/{steps} - {_items(logs)} - "
                  f"{dt * 1000:.0f}ms/step")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done - {_items(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs)

    def _check(self, logs):
        logs = logs or {}
        cur = logs.get(self.monitor, logs.get(f"eval_{self.monitor}"))
        if cur is None:
            return
        cur = cur[0] if isinstance(cur, (list, tuple)) else cur
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched

        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None, mode="train"):
    """The callbacks of a ``fit``: those given, a ``ProgBarLogger`` first
    (when ``verbose``), an ``LRScheduler`` and, with ``save_dir``, a
    ``ModelCheckpoint`` where none was given; bound to ``model``."""
    if isinstance(callbacks, (list, tuple)):
        cbks = list(callbacks)
    else:
        cbks = [callbacks] if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return lst


class ReduceLROnPlateau(Callback):
    """Drive an optimizer.lr.ReduceOnPlateau scheduler from a monitored
    metric at epoch end (paddle.callbacks.ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, mode="auto",
                 min_delta=1e-4, cooldown=0, min_lr=0.0, verbose=1):
        super().__init__()
        self.monitor = monitor
        self._kw = dict(factor=factor, patience=patience,
                        threshold=min_delta, cooldown=cooldown, min_lr=min_lr,
                        mode="min" if mode in ("auto", "min") else "max")
        self._sched = None

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        if isinstance(val, (list, tuple)):
            val = val[0]
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        if self._sched is None:
            from ..optimizer.lr import ReduceOnPlateau

            lr = opt.get_lr()
            self._sched = ReduceOnPlateau(learning_rate=lr, **self._kw)
            opt._learning_rate = self._sched
        self._sched.step(float(val))
