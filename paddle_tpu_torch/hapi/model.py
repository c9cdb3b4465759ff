"""``Model`` — the high-level train / eval / predict loop, counterpart of
``paddle_tpu/hapi/model.py``.

The engine is the eager path: the network's call, ``loss.backward()``
and ``optimizer.step()``. ``train_batch`` returns ``float(loss)`` for
every batch, as the reference does, which waits for the card each step.
``save`` / ``load`` go through ``framework.io_save`` (``.pdparams`` and
``.pdopt``), so a ``Model.save`` of the JAX package loads here.
``prepare(jit_compile=True)`` trains through ``jit.TrainStep`` (the
whole step one CUDA graph per batch signature on the card), with the
reference's rules: metrics are not computed in the compiled step (a
warning says so), ``update=False`` raises, and so does a label count
that changes between calls. ``amp_configs`` is stored and not used, as
in the reference. ``summary_of`` lists the parameters in the
reference's order (``Layer._parameter_items``).
"""

from __future__ import annotations

import os
import warnings
from typing import List

import numpy as np

import torch

from ..core.autograd import no_grad
from ..core.tensor import Tensor
from ..framework import io_save
from ..io import DataLoader, Dataset
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model", "summary"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_tensor(x):
    if isinstance(x, Tensor):
        return x
    return Tensor(x if isinstance(x, torch.Tensor) else np.asarray(x))


def _batch_len(x, default):
    """Leading-dim size of a batch element (Tensor or numpy)."""
    try:
        return int(x.shape[0])
    except Exception:
        return default


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._train_step = None  # compiled TrainStep when jit_compile=True

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile: bool = False):
        self._train_step = None  # re-prepare drops any old compiled step
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be a Layer or a callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metric {m} is not a paddle_tpu_torch.metric.Metric")
        self._amp_configs = amp_configs
        if jit_compile:
            from ..jit import TrainStep
            if self._metrics:
                warnings.warn(
                    "jit_compile=True: train-loop metrics are not computed "
                    "inside the compiled step (evaluate() still reports them)")
            loss_fn = self._loss
            model_self = self

            def step_loss(model, *batch):
                # _jit_n_labels is pinned by train_batch before the first
                # call, i.e. before the step is first run
                n = model_self._jit_n_labels
                outs = _to_list(model(*batch[:-n] if n else batch))
                labs = list(batch[-n:]) if n else []
                losses = _to_list(loss_fn(*(outs + labs)))
                total = losses[0]
                for extra in losses[1:]:
                    total = total + extra
                return total

            self._jit_n_labels = None
            self._train_step = TrainStep(self.network, step_loss, optimizer)
        return self

    def parameters(self):
        return self.network.parameters()

    # -- single-batch paths ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = [_to_tensor(x) for x in _to_list(inputs)]
        labels = [_to_tensor(y) for y in _to_list(labels)]
        if self._train_step is not None:
            if not update:
                raise ValueError(
                    "gradient accumulation (update=False) is not supported "
                    "with jit_compile=True; fold accumulation into the "
                    "compiled step or use the eager path")
            if self._jit_n_labels is None:
                self._jit_n_labels = len(labels)
            elif self._jit_n_labels != len(labels):
                raise ValueError(
                    f"label count changed between jit-compiled train_batch "
                    f"calls ({self._jit_n_labels} -> {len(labels)})")
            loss = self._train_step(*inputs, *labels)
            return [float(loss)]
        outputs = self.network(*inputs)
        losses = self._loss(*(_to_list(outputs) + labels))
        losses = _to_list(losses)
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        self._update_metrics(outputs, labels)
        return [float(l) for l in losses]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = [_to_tensor(x) for x in _to_list(inputs)]
        labels = [_to_tensor(y) for y in _to_list(labels)]
        with no_grad():
            outputs = self.network(*inputs)
            losses = []
            if self._loss is not None:
                losses = [float(l) for l in
                          _to_list(self._loss(*(_to_list(outputs) + labels)))]
        self._update_metrics(outputs, labels)
        return losses

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = [_to_tensor(x) for x in _to_list(inputs)]
        with no_grad():
            outputs = self.network(*inputs)
        return [o.numpy() if isinstance(o, Tensor)
                else o.detach().cpu().numpy() for o in _to_list(outputs)]

    def _update_metrics(self, outputs, labels):
        outs = _to_list(outputs)
        for m in self._metrics:
            stats = m.compute(*(outs + labels))
            m.update(*_to_list(stats))

    def _metric_logs(self, logs):
        for m in self._metrics:
            res = m.accumulate()
            names = m.name()
            if isinstance(names, (list, tuple)):
                for n, r in zip(names, _to_list(res)):
                    logs[n] = r
            else:
                logs[names] = res
        return logs

    # -- loops ---------------------------------------------------------------
    @staticmethod
    def _as_loader(data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data  # any iterable of batches

    @staticmethod
    def _split_batch(batch):
        batch = _to_list(batch)
        if len(batch) < 2:
            return batch, []
        return batch[:-1], batch[-1:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        assert train_data is not None, "train_data must be given!"
        loader = self._as_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        metric_names = ["loss"]
        for m in self._metrics:
            metric_names.extend(_to_list(m.name()))
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, save_freq=save_freq,
            save_dir=save_dir, verbose=verbose, metrics=metric_names)
        self.stop_training = False
        cbks.on_train_begin()
        history = []
        total_iters = 0
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = {}
            pending_grads = False
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                update = (step + 1) % accumulate_grad_batches == 0
                losses = self.train_batch(ins, labs, update=update)
                pending_grads = not update
                logs["loss"] = losses[0] if len(losses) == 1 else losses
                logs["batch_size"] = (_batch_len(ins[0], batch_size)
                                      if ins else batch_size)
                self._metric_logs(logs)
                cbks.on_train_batch_end(step, logs)
                total_iters += 1
                if num_iters is not None and total_iters >= num_iters:
                    self.stop_training = True
                    break
            if pending_grads:
                # flush a partial accumulation group so stale grads never
                # leak into the next epoch's first update
                self._optimizer.step()
                self._optimizer.clear_grad()
            cbks.on_epoch_end(epoch, logs)
            history.append(dict(logs))
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              log_freq=log_freq, verbose=verbose,
                              callbacks=cbks, _in_fit=True)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _in_fit=False):
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbks = callbacks if _in_fit else config_callbacks(
            callbacks, model=self, batch_size=batch_size, verbose=verbose,
            log_freq=log_freq, mode="eval")
        for m in self._metrics:
            m.reset()
        metric_names = []
        for m in self._metrics:
            metric_names.extend(_to_list(m.name()))
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks.on_eval_begin({"steps": steps,
                            "metrics": ["loss"] + metric_names})
        logs = {}
        seen = 0
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            losses = self.eval_batch(ins, labs)
            if losses:
                logs["loss"] = losses[0] if len(losses) == 1 else losses
            seen += _batch_len(ins[0], 0) if ins else 0
            self._metric_logs(logs)
            cbks.on_eval_batch_end(step, logs)
            if num_samples is not None and seen >= num_samples:
                break
        logs["samples"] = seen
        cbks.on_eval_end(logs)
        return {k: v for k, v in logs.items() if k != "samples"}

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        cbks = config_callbacks(callbacks, model=self, batch_size=batch_size,
                                verbose=verbose, mode="predict")
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins = _to_list(batch)
            # when the Model declared input specs, only that many leading
            # elements are inputs (a test loader may still carry labels)
            if self._inputs:
                ins = ins[: len(self._inputs)]
            outs = self.predict_batch(ins)
            outputs.append(outs)
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        # transpose [steps][n_out] -> [n_out][steps]
        n_out = len(outputs[0]) if outputs else 0
        cols = [[o[i] for o in outputs] for i in range(n_out)]
        if stack_outputs:
            cols = [np.concatenate(c, axis=0) for c in cols]
        return cols

    # -- persistence ----------------------------------------------------------
    def save(self, path, training=True):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        io_save.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            io_save.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = io_save.load(path + ".pdparams")
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(io_save.load(opt_path))

    def summary(self, input_size=None, dtype=None):
        return summary_of(self.network)


def summary_of(network):
    total, trainable = 0, 0
    rows = []
    for name, p in network.named_parameters():
        n = int(np.prod(tuple(p.shape) or (1,)))
        total += n
        if getattr(p, "trainable", p.requires_grad):
            trainable += n
        rows.append((name, tuple(p.shape), n))
    return {"total_params": total, "trainable_params": trainable,
            "layers": rows}


def summary(net, input_size=None, dtypes=None):
    """paddle.summary parity (prints a small table, returns the dict)."""
    info = summary_of(net)
    width = max([len(r[0]) for r in info["layers"]] + [10])
    print(f"{'Param':<{width}}  Shape            #")
    for name, shape, n in info["layers"]:
        print(f"{name:<{width}}  {str(shape):<15}  {n}")
    print(f"Total params: {info['total_params']}  "
          f"(trainable {info['trainable_params']})")
    return {"total_params": info["total_params"],
            "trainable_params": info["trainable_params"]}
