"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping`` and ``VisualDL``. As in the reference, ``Model.fit``
takes callbacks and does not call them: their hooks run when a caller
calls them."""

from __future__ import annotations

import numbers

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler", "EarlyStopping",
           "VisualDL"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    """Prints ``step {step}: k: v - ...`` every ``log_freq`` steps."""

    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0 and logs:
            msg = " - ".join(f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                             for k, v in logs.items())
            print(f"step {step}: {msg}")


class ModelCheckpoint(Callback):
    """``model.save(f"{save_dir}/{epoch}")`` every ``save_freq`` epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class LRScheduler(Callback):
    """Steps the model optimizer's learning-rate scheduler after each
    batch (``by_step``) or epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class EarlyStopping(Callback):
    """Sets ``stopped`` once ``monitor`` has not improved by ``min_delta``
    for ``patience`` evaluations ("auto" and "min": lower is better)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1, min_delta=0,
                 baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped = False
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_eval_end(self, logs=None):
        if not logs or self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        improved = (self.best is None or
                    (cur < self.best - self.min_delta if self.mode == "min"
                     else cur > self.best + self.min_delta))
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True


class VisualDL(Callback):
    """Writes the numeric logs of each training batch (``train/{k}`` at the
    step) and each evaluation (``eval/{k}`` at the evaluation's count)
    through ``utils.LogWriter`` into ``log_dir``."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self._writer = None
        self._eval_count = 0

    def _get_writer(self):
        if self._writer is None:
            from ..utils import LogWriter

            self._writer = LogWriter(self.log_dir)
        return self._writer

    def on_train_batch_end(self, step, logs=None):
        w = self._get_writer()
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                w.add_scalar(f"train/{k}", v, step)

    def on_eval_end(self, logs=None):
        w = self._get_writer()
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                w.add_scalar(f"eval/{k}", v, self._eval_count)
        self._eval_count += 1

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
