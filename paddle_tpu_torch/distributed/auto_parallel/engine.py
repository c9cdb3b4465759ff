"""Auto-parallel Engine: fit/evaluate/predict over a sharded model —
counterpart of ``paddle_tpu/distributed/auto_parallel/engine.py``.

As in the reference, the Engine honours the placements that
``shard_tensor``/``shard_layer`` installed (here: each rank's parameter
slabs), builds one ``jit.TrainStep`` and reuses it across the epoch
loop, and keeps the reference's fit/evaluate/predict surface.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ...core.host_arrays import to_host
from ...core.tensor import Tensor
from ...nn.layer import Layer


def _as_tensor(x):
    return x if isinstance(x, Tensor) else Tensor(x)


class Engine:
    def __init__(self, model: Layer, loss=None, optimizer=None, metrics=None,
                 strategy=None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics or []
        self.strategy = strategy
        self._train_step = None
        self.history: list = []

    # -- internals -----------------------------------------------------------

    def _loader(self, data, batch_size):
        from ...io import DataLoader
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=False)

    def _build_train_step(self):
        from ...jit import TrainStep
        loss_fn = self.loss

        def step_loss(model, *batch):
            *xs, y = batch
            out = model(*xs)
            return loss_fn(out, y)

        self._train_step = TrainStep(self.model, step_loss, self.optimizer)

    # -- public surface (reference Engine) -----------------------------------

    def fit(self, train_data, epochs: int = 1, batch_size: int = 1,
            steps_per_epoch: Optional[int] = None, log_freq: int = 10,
            verbose: int = 0):
        assert self.loss is not None and self.optimizer is not None, \
            "Engine.fit needs loss and optimizer"
        if self._train_step is None:
            self._build_train_step()
        loader = self._loader(train_data, batch_size)
        for epoch in range(epochs):
            losses = []
            for step, batch in enumerate(loader):
                if steps_per_epoch is not None and step >= steps_per_epoch:
                    break
                batch = batch if isinstance(batch, (list, tuple)) else [batch]
                loss = self._train_step(*batch)
                losses.append(float(loss))
                if verbose and step % log_freq == 0:
                    print(f"epoch {epoch} step {step}: loss {losses[-1]:.5f}")
            self.history.append({"epoch": epoch,
                                 "loss": float(np.mean(losses))})
        return self.history

    def evaluate(self, valid_data, batch_size: int = 1,
                 steps: Optional[int] = None):
        assert self.loss is not None
        from ...core import autograd as _ag
        loader = self._loader(valid_data, batch_size)
        losses = []
        with _ag.no_grad():
            self.model.eval()
            for step, batch in enumerate(loader):
                if steps is not None and step >= steps:
                    break
                batch = batch if isinstance(batch, (list, tuple)) else [batch]
                *xs, y = batch
                out = self.model(*[_as_tensor(x) for x in xs])
                losses.append(float(self.loss(out, _as_tensor(y))))
            self.model.train()
        return {"loss": float(np.mean(losses)) if losses else None}

    def predict(self, test_data, batch_size: int = 1,
                steps: Optional[int] = None):
        from ...core import autograd as _ag
        loader = self._loader(test_data, batch_size)
        outs = []
        with _ag.no_grad():
            self.model.eval()
            for step, batch in enumerate(loader):
                if steps is not None and step >= steps:
                    break
                batch = batch if isinstance(batch, (list, tuple)) else [batch]
                xs = batch[:-1] if len(batch) > 1 else batch
                out = self.model(*[_as_tensor(x) for x in xs])
                outs.append(to_host(getattr(out, "_value", out)))
            self.model.train()
        return outs


def shard_layer(layer: Layer, process_mesh, shard_fn: Optional[Callable] = None,
                input_fn=None, output_fn=None) -> Layer:
    """Parity with paddle.distributed.shard_layer: place every parameter
    according to ``shard_fn(name, layer, process_mesh) -> placements`` (or
    replicate when no fn is given): each becomes this rank's slab."""
    from .api import Replicate, _place_param, shard_tensor

    for name, param in layer.named_parameters():
        placements = None
        if shard_fn is not None:
            placements = shard_fn(name, layer, process_mesh)
        if placements is None:
            placements = [Replicate() for _ in process_mesh.shape]
        sharded = shard_tensor(param.detach(), process_mesh, placements,
                               stop_gradient=not param.requires_grad)
        if sharded.is_distributed:
            _place_param(param, sharded)
    return layer
