"""Durable checkpoints over ``distributed.checkpoint`` — counterpart of
``paddle_tpu/resilience/durable.py`` (l.36-249).

Commit protocol: write the checkpoint into a ``.tmp_step_<N>`` staging
directory (every file atomically written, fsynced and CRC32'd by the
checkpoint package), rename the staging directory to ``step_<N>``, then
flip the ``LATEST`` marker and collect old checkpoints. Load walks
``LATEST`` first, then the rest newest first, verifying checksums, and
takes the newest intact one: a truncated or torn checkpoint is logged,
counted and skipped, never half-read.

A restore builds its load target from the checkpoint's own metadata
(host tensors of the saved dtypes, zeros until loaded), so optimizer
state a fresh process has not made yet comes back too; the train state
then copies it onto the model's and the optimizer's devices.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..distributed.checkpoint.async_save import (AsyncSaveFuture,
                                                 host_snapshot,
                                                 spawn_async_writer)
from ..distributed.checkpoint.load_state_dict import (load_state_dict,
                                                      read_metadata)
from ..distributed.checkpoint.save_state_dict import save_state_dict
from ..distributed.checkpoint.utils import (BF16, CheckpointCorruptError,
                                            atomic_write, fsync_dir,
                                            unflatten_state_dict)

logger = logging.getLogger("paddle_tpu_torch.resilience")

STEP_PREFIX = "step_"
STAGING_PREFIX = ".tmp_"
LATEST_MARKER = "LATEST"


def checkpoint_path(root: str, step: int) -> str:
    return os.path.join(root, f"{STEP_PREFIX}{int(step)}")


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """Committed checkpoints under ``root``, oldest first."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if not name.startswith(STEP_PREFIX):
            continue
        try:
            step = int(name[len(STEP_PREFIX):])
        except ValueError:
            continue
        full = os.path.join(root, name)
        if os.path.isdir(full):
            out.append((step, full))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    """Step the ``LATEST`` marker points at (checked against disk), or
    the newest committed step directory when the marker is missing or
    stale."""
    marker = os.path.join(root, LATEST_MARKER)
    try:
        with open(marker, "r") as f:
            name = f.read().strip()
        if name.startswith(STEP_PREFIX) and \
                os.path.isdir(os.path.join(root, name)):
            return int(name[len(STEP_PREFIX):])
    except (OSError, ValueError):
        pass
    ckpts = list_checkpoints(root)
    return ckpts[-1][0] if ckpts else None


def _clean_staging(root: str) -> None:
    """Remove staging litter of crashed saves (saves are serialized, so
    any ``.tmp_*`` directory seen here is dead)."""
    if not os.path.isdir(root):
        return
    for name in os.listdir(root):
        if name.startswith(STAGING_PREFIX):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def gc_checkpoints(root: str, keep: Optional[int]) -> List[int]:
    """Delete all but the newest ``keep`` committed checkpoints; returns
    the deleted steps. Stale staging directories go whatever ``keep``."""
    deleted: List[int] = []
    _clean_staging(root)
    if keep is None or keep <= 0:
        return deleted
    ckpts = list_checkpoints(root)
    for step, path in ckpts[:-keep] if len(ckpts) > keep else []:
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(step)
    if deleted:
        logger.info("checkpoint GC: dropped steps %s under %s", deleted, root)
    return deleted


def _commit(snapshot: Dict[str, Any], root: str, step: int,
            keep: Optional[int], fault_injector=None) -> str:
    """The write half of a durable save: stage, rename, ``LATEST``, GC.
    Runs on the caller's thread or an async writer thread."""
    os.makedirs(root, exist_ok=True)
    staging = os.path.join(root, f"{STAGING_PREFIX}{STEP_PREFIX}{int(step)}")
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    if fault_injector is not None and fault_injector.fire("write_fail", step):
        fault_injector.leave_partial_staging(staging)
        raise IOError(
            f"injected write failure during checkpoint save at step {step}")
    save_state_dict(snapshot, staging)
    final = checkpoint_path(root, step)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(staging, final)  # atomic commit: the dir appears whole or not
    fsync_dir(root)
    atomic_write(os.path.join(root, LATEST_MARKER),
                 lambda f: f.write(f"{STEP_PREFIX}{int(step)}".encode()))
    if fault_injector is not None and fault_injector.fire("truncate_shard",
                                                          step):
        fault_injector.truncate_shard(final)
    gc_checkpoints(root, keep)  # also sweeps dead staging from past crashes
    return final


def save_checkpoint(state_dict: Dict[str, Any], root: str, step: int,
                    keep: Optional[int] = None,
                    fault_injector=None) -> str:
    """Durably save ``state_dict`` as ``<root>/step_<step>`` (sync)."""
    snapshot = host_snapshot(state_dict)
    return _commit(snapshot, root, step, keep, fault_injector)


def async_save_checkpoint(state_dict: Dict[str, Any], root: str, step: int,
                          keep: Optional[int] = None,
                          fault_injector=None) -> AsyncSaveFuture:
    """Durable save with the host snapshot taken now and the staged
    commit on a background thread (after any in-flight async save).
    ``result()`` returns the committed ``step_<N>`` path."""
    snapshot = host_snapshot(state_dict)
    fut = AsyncSaveFuture()
    fut.path = checkpoint_path(root, step)
    t0 = time.perf_counter()

    def write():
        _commit(snapshot, root, step, keep, fault_injector)
        fut.elapsed_s = time.perf_counter() - t0

    return spawn_async_writer(fut, write)


# -- load side ---------------------------------------------------------------

def _torch_dtype(name: str) -> torch.dtype:
    if name == BF16:
        return torch.bfloat16
    return getattr(torch, name)


def _target_from_metadata(meta) -> Dict[str, Any]:
    """A state dict covering every key the checkpoint holds: host zeros
    of each tensor's global shape and saved dtype, and the metadata's
    scalars. Loading into a fresh ``TrainState`` alone would drop keys a
    fresh process has not made yet, e.g. optimizer moments before the
    first step."""
    flat: Dict[str, Any] = {}
    for key, shards in meta.state_dict_metadata.items():
        if not shards:
            continue
        ndim = len(shards[0].local_shape)
        gshape = [0] * ndim
        for s in shards:
            for d in range(ndim):
                gshape[d] = max(gshape[d],
                                s.global_offset[d] + s.local_shape[d])
        flat[key] = torch.zeros(tuple(gshape),
                                dtype=_torch_dtype(shards[0].dtype))
    for key, value in getattr(meta, "aux", {}).items():
        flat.setdefault(key, value)
    return unflatten_state_dict(flat, meta.flat_mapping)


def _candidates(root: str) -> List[Tuple[int, str]]:
    """Checkpoints to try, best first: LATEST's target, then newest
    first."""
    ckpts = dict(list_checkpoints(root))
    order: List[int] = []
    marked = latest_step(root)
    if marked is not None and marked in ckpts:
        order.append(marked)
    order.extend(s for s in sorted(ckpts, reverse=True) if s not in order)
    return [(s, ckpts[s]) for s in order]


# A checkpoint raising one of these on load is unusable, not fatal: it is
# skipped for the next-newest. Deliberately narrow: a shape or key
# mismatch from an intact but incompatible checkpoint must surface.
_UNUSABLE = (CheckpointCorruptError, FileNotFoundError, OSError)


def _first_intact(root: str, load, metrics=None):
    """``(step, load(path))`` for the newest candidate that loads cleanly;
    unusable ones are logged, counted and skipped. ``(None, None)`` if
    none."""
    for step, path in _candidates(root):
        try:
            return step, load(path)
        except _UNUSABLE as e:
            logger.warning("skipping unusable checkpoint %s: %s", path, e)
            if metrics is not None:
                metrics.inc("corrupt_checkpoints_skipped")
    return None, None


def load_latest_checkpoint(state_dict: Dict[str, Any], root: str,
                           metrics=None) -> Optional[int]:
    """Fill ``state_dict`` from the newest intact checkpoint under
    ``root`` (checksums verified); returns its step, or None when nothing
    loadable exists."""
    step, _ = _first_intact(
        root, lambda path: load_state_dict(state_dict, path), metrics)
    return step


def restore_train_state(train_state, root: str,
                        metrics=None) -> Optional[int]:
    """Restore a ``TrainState`` from the newest intact checkpoint,
    building the load target from the checkpoint's metadata so every
    saved key comes back. Returns the restored global step, or None."""

    def load(path):
        target = _target_from_metadata(read_metadata(path))
        load_state_dict(target, path)
        return target

    step, target = _first_intact(root, load, metrics)
    if step is None:
        return None
    train_state.set_state_dict(target)
    if metrics is not None:
        metrics.inc("restores")
    return train_state.global_step
