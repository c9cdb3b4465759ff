"""hapi callbacks — counterpart of ``paddle_tpu/hapi/callbacks.py``:
``config_callbacks``, ``CallbackList``, ``Callback``, ``ProgBarLogger``,
``ModelCheckpoint``, ``LRScheduler``, ``EarlyStopping``,
``ReduceLROnPlateau`` and ``VisualDL``, printing and writing the
reference's text. ``VisualDL`` appends the reference's plain-text scalar
log (one ``step<TAB>name<TAB>value`` line per scalar) under
``log_dir``. ``EarlyStopping`` keeps its best weights as host copies."""

from __future__ import annotations

import numbers
import os
import warnings
from typing import List, Optional

import numpy as np

from .progressbar import ProgressBar


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, ModelCheckpoint) for c in cbks) and save_dir:
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"],
    })
    return lst


class CallbackList:
    def __init__(self, callbacks: Optional[List["Callback"]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cbk):
        self.callbacks.append(cbk)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            fn = getattr(c, name, None)
            if fn is not None:
                fn(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    # train/eval/predict begin|end; epoch begin|end; batch begin|end
    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.train_metrics = self.params.get("metrics", ["loss"])

    def on_epoch_begin(self, epoch, logs=None):
        self.steps = self.params.get("steps")
        self.epoch = epoch
        self.train_step = 0
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")
        self.train_progbar = ProgressBar(num=self.steps, verbose=self.verbose)

    def _updates(self, logs, bar):
        values = [(k, logs[k]) for k in self.train_metrics if k in logs]
        bar.update(self.train_step, values)

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        self.train_step += 1
        if self.verbose and self.train_step % self.log_freq == 0:
            self._updates(logs, self.train_progbar)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose and logs:
            self._updates(logs, self.train_progbar)

    def on_eval_begin(self, logs=None):
        logs = logs or {}
        self.eval_steps = logs.get("steps")
        self.eval_metrics = logs.get("metrics", ["loss"])
        self.eval_step = 0
        self.eval_progbar = ProgressBar(num=self.eval_steps, verbose=self.verbose)
        if self.verbose:
            print("Eval begin...")

    def on_eval_batch_end(self, step, logs=None):
        logs = logs or {}
        self.eval_step += 1
        if self.verbose and self.eval_step % self.log_freq == 0:
            values = [(k, logs[k]) for k in self.eval_metrics if k in logs]
            self.eval_progbar.update(self.eval_step, values)

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            values = [(k, logs[k]) for k in getattr(self, "eval_metrics", [])
                      if k in logs]
            self.eval_progbar.update(self.eval_step, values)
            print("Eval samples: ", logs.get("samples", ""))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and \
                epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler; by_step (default) or by_epoch."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None) if self.model else None
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.wait_epoch = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            warnings.warn(f"EarlyStopping mode {mode} unknown, using 'auto'")
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in self.monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        self.best_value = self.baseline if self.baseline is not None else (
            np.inf if self.monitor_op == np.less else -np.inf)

    def on_epoch_end(self, epoch, logs=None):
        self.stopped_epoch = epoch

    def on_eval_end(self, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            warnings.warn(f"Monitor of EarlyStopping should be loss or metric "
                          f"name; {self.monitor} missing in eval logs")
            return
        if isinstance(current, (list, tuple, np.ndarray)):
            current = float(np.asarray(current).ravel()[0])
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.model is not None:
                self.best_weights = {
                    k: v.detach().cpu().numpy().copy()
                    for k, v in self.model.network.state_dict().items()}
        else:
            self.wait_epoch += 1
        if self.wait_epoch >= self.patience:
            self.model.stop_training = True
            if self.verbose:
                print(f"Epoch {self.stopped_epoch + 1}: early stopping")

    def on_train_end(self, logs=None):
        # restore the best-seen weights
        if self.save_best_model and self.best_weights is not None:
            self.model.network.set_state_dict(self.best_weights)


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self.best = -np.inf
        else:
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self.best = np.inf

    def on_eval_end(self, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            return
        if isinstance(current, (list, tuple, np.ndarray)):
            current = float(np.asarray(current).ravel()[0])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.monitor_op(current, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None and not hasattr(opt._learning_rate, "step"):
                    old = float(opt.get_lr())
                    new = max(old * self.factor, self.min_lr)
                    if old - new > 1e-12:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr {old:g} -> {new:g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalar logger: the numeric logs appended to ``<log_dir>/train.log``
    each batch and ``<log_dir>/eval.log`` after each evaluation."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def _write(self, mode, logs):
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"{mode}.log")
        with open(path, "a") as f:
            for k, v in (logs or {}).items():
                if isinstance(v, numbers.Number):
                    f.write(f"{self._step}\t{k}\t{v}\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)
