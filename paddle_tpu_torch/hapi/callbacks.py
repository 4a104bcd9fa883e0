"""Training callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

``Callback``, ``CallbackList``, ``config_callbacks``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler`` (steps the
optimizer's ``optimizer/lr.py`` scheduler) and ``ReduceLROnPlateau``, as
in the reference, and its observability callbacks: ``VisualDL`` (a TSV of
scalars), ``TelemetryLogger`` (per-step telemetry into the port's
``observability``; ``config_callbacks`` appends one) and
``WandbCallback`` (needs the ``wandb`` package).
"""
from __future__ import annotations

import os
import time

import numpy as np

from .. import observability as _obs


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


class VisualDL(Callback):
    """Scalar logger: one ``step<TAB>key<TAB>value`` row of
    ``log_dir/scalars.tsv`` per numeric log a batch (VisualDL itself is
    outside the repo)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.tsv"), "a") as f:
            for k, v in (logs or {}).items():
                if isinstance(v, (int, float)):
                    f.write(f"{self._step}\t{k}\t{v}\n")
        self._step += 1


class TelemetryLogger(Callback):
    """Per-step training telemetry into the port's ``observability``: the
    tokens/s gauge (``batch_size`` a second, as the reference counts it),
    the FLOP/s and MFU gauges when ``logs["step_flops"]`` is given (MFU
    against ``PADDLE_TPU_PEAK_FLOPS``, the card's peak FLOP/s), and one
    ``train_step`` event a batch. ``config_callbacks`` appends one; it
    costs one env lookup a batch unless ``PADDLE_TPU_TELEMETRY_DIR`` is
    set."""

    def __init__(self):
        super().__init__()
        self._t0 = None

    def on_train_begin(self, logs=None):
        _obs.event("train_run", phase="begin",
                   epochs=self.params.get("epochs"),
                   steps=self.params.get("steps"))

    def on_train_end(self, logs=None):
        _obs.event("train_run", phase="end")
        _obs.flush()

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter() if _obs.enabled() else None

    def on_train_batch_end(self, step, logs=None):
        if self._t0 is None:
            return
        dt = max(time.perf_counter() - self._t0, 1e-9)
        self._t0 = None
        logs = logs or {}
        fields = {"step": int(step), "seconds": round(dt, 6)}
        loss = logs.get("loss")
        if isinstance(loss, (list, tuple, np.ndarray)):
            loss = loss[0] if len(loss) else None
        try:
            fields["loss"] = float(loss)
        except (TypeError, ValueError):
            pass
        bs = logs.get("batch_size")
        if bs:
            tps = float(bs) / dt
            _obs.set_gauge("train_tokens_per_second", tps)
            fields["tokens_per_second"] = round(tps, 3)
        flops = logs.get("step_flops")
        if flops:
            fps = float(flops) / dt
            _obs.set_gauge("train_flops_per_second", fps)
            try:
                peak = float(os.environ.get("PADDLE_TPU_PEAK_FLOPS", "0")
                             or 0)
            except ValueError:
                peak = 0.0
            if peak > 0:
                mfu = fps / peak
                _obs.set_gauge("train_mfu", mfu)
                fields["mfu"] = round(mfu, 6)
        _obs.event("train_step", **fields)


class WandbCallback(Callback):
    """paddle.callbacks.WandbCallback: train / eval metrics to a Weights &
    Biases run. ``wandb`` is an optional dependency, as in the reference:
    without it the constructor raises ``ImportError``."""

    def __init__(self, project=None, entity=None, name=None, dir=None,
                 mode=None, job_type=None, **kwargs):
        super().__init__()
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "WandbCallback requires the `wandb` package, which is not "
                "installed in this environment (`pip install wandb`)") from e
        self.wandb = wandb
        self._run = wandb.init(
            project=project, entity=entity, name=name, dir=dir, mode=mode,
            job_type=job_type, **kwargs)

    def on_train_batch_end(self, step, logs=None):
        self._run.log({f"train/{k}": v for k, v in (logs or {}).items()})

    def on_eval_end(self, logs=None):
        self._run.log({f"eval/{k}": v for k, v in (logs or {}).items()})

    def on_train_end(self, logs=None):
        self._run.finish()


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None, mode="train"):
    """The callbacks of a ``fit``: those given, a ``ProgBarLogger`` first
    (when ``verbose``), an ``LRScheduler``, with ``save_dir`` a
    ``ModelCheckpoint``, and a ``TelemetryLogger`` where none was given;
    bound to ``model``."""
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
    if not any(isinstance(c, TelemetryLogger) for c in cbks):
        cbks = cbks + [TelemetryLogger()]
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
