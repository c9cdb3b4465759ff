"""Async checkpointing and the whole train state — counterpart of
``paddle_tpu/distributed/checkpoint/async_save.py`` (l.26-204).

* :func:`async_save_state_dict`: the host snapshot now, the file writes
  on a background thread; :meth:`AsyncSaveFuture.result` joins.
* :class:`TrainState`: model parameters, optimizer state, LR scheduler,
  global step and data-loader position in one state dict, so a restart
  resumes mid-epoch.

The port's optimizers update parameters, moments and master weights in
place, so :func:`host_snapshot` returns only once every byte is on the
host: card tensors go by non-blocking copies into pinned host memory,
and the copies' event is waited on before it returns; host tensors are
cloned.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core.dtype import X64_TO_32
from ...core.tensor import Tensor
from .save_state_dict import save_state_dict


class AsyncSaveFuture:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._ok = False  # set by the writer only after a successful commit
        self.path: Optional[str] = None

    def result(self, timeout: Optional[float] = None) -> str:
        """Join the writer. Raises ``TimeoutError`` if it is still running
        after ``timeout`` seconds, re-raises the writer's exception if it
        failed, and only returns ``path`` once the write completed."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"async checkpoint to {self.path!r} still writing "
                    f"after {timeout}s")
        if self._exc is not None:
            raise self._exc
        if not self._ok:
            raise RuntimeError(
                f"async checkpoint to {self.path!r} never ran to completion")
        return self.path

    def exception(self, timeout: Optional[float] = None):
        """Join and return the writer's exception (None on success);
        ``TimeoutError`` still raises."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"async checkpoint to {self.path!r} still writing "
                    f"after {timeout}s")
        return self._exc

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()


_last_save = [None]  # serialize overlapping async saves


def host_snapshot(state_dict):
    """A nested state dict with every tensor copied to the host now:
    torch tensors (card tensors in pinned memory, complete when this
    returns), numpy arrays copied, scalars as 0-d arrays."""
    events = []

    def snap(v):
        if isinstance(v, dict):
            return {k: snap(x) for k, x in v.items()}
        if isinstance(v, Tensor):
            v = v._value
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.device.type == "cpu":
                return v.clone()
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            if not events:
                events.append(v.device)
            return host
        return np.array(v)

    out = snap(state_dict)
    for dev in events:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return out


def spawn_async_writer(fut: AsyncSaveFuture, write) -> AsyncSaveFuture:
    """Run ``write()`` on a daemon thread, after any in-flight async save
    (resume needs the order kept). A previous save's error is not
    re-raised here: it belongs to the caller holding that future."""
    prev = _last_save[0]
    if prev is not None and prev._thread is not None:
        prev._thread.join()

    def runner():
        try:
            write()
            fut._ok = True
        except BaseException as e:  # surfaced at result()
            fut._exc = e

    fut._thread = threading.Thread(target=runner, daemon=True)
    fut._thread.start()
    _last_save[0] = fut
    return fut


def async_save_state_dict(state_dict: Dict[str, Any], path: str,
                          process_group=None, coordinator_rank: int = 0
                          ) -> AsyncSaveFuture:
    """Host snapshot now; file writes on a background thread."""
    snapshot = host_snapshot(state_dict)
    fut = AsyncSaveFuture()
    fut.path = path

    def write():
        save_state_dict(snapshot, path, process_group=process_group,
                        coordinator_rank=coordinator_rank)

    return spawn_async_writer(fut, write)


def _wrap_leaves(tree):
    """Tensor leaves for checkpoint IO: tensors stay as they are; an
    array or a Python scalar (the optimizer's ``@step``, the scheduler's
    values) becomes a host tensor. Integers take the reference's x64-off
    dtypes (int32); a Python float stays float64, so a restored learning
    rate is the saved one bit for bit."""
    if isinstance(tree, dict):
        return {k: _wrap_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (Tensor, torch.Tensor)):
        return tree
    if isinstance(tree, float):
        return torch.tensor(tree, dtype=torch.float64)
    t = torch.from_numpy(np.array(tree))
    return t.to(X64_TO_32.get(t.dtype, t.dtype))


def _unwrap_leaves(tree):
    """Back to what the state's consumers take: tensors stay torch
    tensors (a bfloat16 one does not pass through numpy), 0-d ones become
    Python scalars."""
    if isinstance(tree, dict):
        return {k: _unwrap_leaves(v) for k, v in tree.items()}
    if isinstance(tree, Tensor):
        tree = tree._value
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim == 0:
        return tree.item()
    return tree


class TrainState:
    """One-call capture/restore of everything resume needs."""

    def __init__(self, model=None, optimizer=None, lr_scheduler=None):
        self.model = model
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.global_step = 0
        self.epoch = 0
        self.batch_in_epoch = 0  # dataloader position

    def step(self, batches: int = 1) -> None:
        self.global_step += batches
        self.batch_in_epoch += batches

    def next_epoch(self) -> None:
        self.epoch += 1
        self.batch_in_epoch = 0

    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "progress": {
                "global_step": np.asarray(self.global_step, np.int64),
                "epoch": np.asarray(self.epoch, np.int64),
                "batch_in_epoch": np.asarray(self.batch_in_epoch, np.int64),
            }
        }
        if self.model is not None:
            out["model"] = self.model.state_dict()
        if self.optimizer is not None:
            out["optimizer"] = self.optimizer.state_dict()
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "state_dict"):
            out["lr_scheduler"] = self.lr_scheduler.state_dict()
        return _wrap_leaves(out)

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        state = _unwrap_leaves(state)
        prog = state.get("progress", {})
        self.global_step = int(prog.get("global_step", 0))
        self.epoch = int(prog.get("epoch", 0))
        self.batch_in_epoch = int(prog.get("batch_in_epoch", 0))
        if self.model is not None and "model" in state:
            self.model.set_state_dict(state["model"])
        if self.optimizer is not None and "optimizer" in state:
            self.optimizer.set_state_dict(state["optimizer"])
        if self.lr_scheduler is not None and "lr_scheduler" in state and \
                hasattr(self.lr_scheduler, "set_state_dict"):
            self.lr_scheduler.set_state_dict(state["lr_scheduler"])

    def skip_batches(self, loader):
        """Fast-forward a data loader to the captured mid-epoch position.
        Right under shuffle when the sampler's order is a pure function
        of the epoch: the loader's batch sampler is pinned to the
        captured epoch first."""
        bs = getattr(loader, "batch_sampler", None)
        if bs is not None and hasattr(bs, "set_epoch"):
            bs.set_epoch(self.epoch)
        it = iter(loader)
        for _ in range(self.batch_in_epoch):
            next(it)
        return it
