"""``paddle_tpu_torch.io`` — datasets, samplers and ``DataLoader``,
counterpart of ``paddle_tpu/io/__init__.py``.

The loader is host-side. With ``num_workers > 0`` on a map-style dataset
it spawns worker processes (batch ``b`` from worker ``b % num_workers``,
an ordering buffer on the consumer side, the reference's scheme). A
worker imports numpy, this module and the dataset's own module: no
torch unless the dataset holds Tensors, and never the card
(``CUDA_VISIBLE_DEVICES`` is empty for it). Workers collate to numpy;
the wrap into Tensors (on the current place) happens on the consumer
side. ``RandomSampler`` and ``DistributedBatchSampler`` draw the
reference's permutations (``np.random.RandomState(seed + epoch)``), so a
shuffled resume (``TrainState.skip_batches``) sees the reference's
batches. ``DistributedBatchSampler``'s rank and world size come from
``distributed.env``.
"""

from __future__ import annotations

import math
import os
import queue
import sys
import threading
from typing import Sequence

import numpy as np


def _tensor_type():
    """The port's ``Tensor`` class where it is loaded, else ``()``: a
    worker process that never received a Tensor has not imported torch,
    and no sample it holds can be one."""
    mod = sys.modules.get("paddle_tpu_torch.core.tensor")
    return mod.Tensor if mod is not None else ()


def _as_tensor(value):
    from ..core.tensor import Tensor
    return value if isinstance(value, Tensor) else Tensor(value)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no static length")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        self.tensors = [_as_tensor(np.asarray(t) if not hasattr(t, "_value")
                                   else t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    idx = np.random.permutation(len(dataset))
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, idx[off:off + ln].tolist()))
        off += ln
    return out


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """Epoch-deterministic shuffling: the permutation is a pure function of
    (seed, epoch), so a mid-epoch resume (TrainState.skip_batches after
    set_epoch) replays exactly the already-consumed prefix."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None, seed: int = 0):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.replacement:
            return iter(rng.randint(0, n, size=self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across data-parallel ranks: each rank takes
    every ``nranks``-th index of the (padded) order; rank and world size
    default to ``distributed.env``'s."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import env as _env
            num_replicas = num_replicas if num_replicas is not None else _env.get_world_size()
            rank = rank if rank is not None else _env.get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ---------------------------------------------------------------------------
# collate
# ---------------------------------------------------------------------------
def numpy_collate_fn(batch):
    """Collate to host numpy (no device work): what worker processes run.
    Placement on the card happens in the trainer process, never in a
    worker."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, _tensor_type()):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [numpy_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: numpy_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _wrap_collated(tree):
    if isinstance(tree, np.ndarray):
        return _as_tensor(tree)
    if isinstance(tree, list):
        return [_wrap_collated(e) for e in tree]
    if isinstance(tree, dict):
        return {k: _wrap_collated(v) for k, v in tree.items()}
    return tree


def default_collate_fn(batch):
    # single recursion shared with the multiprocess path: workers run
    # numpy_collate_fn, the trainer side wraps — serial mode composes the
    # same two steps so the two paths cannot drift
    return _wrap_collated(numpy_collate_fn(batch))


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------
class WorkerInfo:
    """What ``get_worker_info()`` returns inside a worker."""

    def __init__(self, id: int, num_workers: int, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = [None]


def get_worker_info():
    return _worker_info[0]


def _worker_loop(dataset, collate_fn, idx_queue, out_queue, init_fn,
                 worker_id: int, num_workers: int):
    """Worker process body.
    Module-level so spawn contexts can pickle it; it imports nothing but
    numpy and the dataset's own module."""
    _worker_info[0] = WorkerInfo(worker_id, num_workers, dataset)
    if init_fn is not None:
        init_fn(worker_id)
    try:
        while True:
            item = idx_queue.get()
            if item is None:
                break
            b, idxs = item
            batch = collate_fn([dataset[i] for i in idxs])
            out_queue.put(("ok", (b, batch)))
        out_queue.put(("done", worker_id))
    except Exception:  # surface the error WITH its stack to the consumer
        import traceback
        out_queue.put(("err", f"worker {worker_id}:\n{traceback.format_exc()}"))


class DataLoader:
    """Batch loader with optional multiprocess workers.

    ``num_workers>0`` on a map-style dataset spawns worker processes:
    batch i goes to worker i % num_workers and an ordering buffer restores
    sequence on the consumer side (the reference's scheme). Transport is
    pickle over an OS pipe (numpy arrays ride the pickle-5 buffer
    protocol). IterableDataset (not index-addressable) uses a prefetch thread."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self._worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("length of IterableDataset-backed loader is unknown")
        return len(self.batch_sampler)

    def _iter_batches(self):
        # the profiler's span (the reference's RecordEvent in the loader)
        from ..profiler.record import host_recorder, RecordEvent

        def _record(make):
            if not host_recorder.enabled:
                return make()
            with RecordEvent("DataLoader", "Dataloader"):
                return make()

        if self._iterable:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield _record(lambda: self.collate_fn(batch))
                    batch = []
            if batch and not self.drop_last:
                yield _record(lambda: self.collate_fn(batch))
            return
        for idx_batch in self.batch_sampler:
            yield _record(lambda: self.collate_fn(
                [self.dataset[i] for i in idx_batch]))

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._iter_batches()
            return
        if not self._iterable:
            yield from self._iter_multiprocess()
            return
        # IterableDataset: prefetch thread (no index addressing to split on)
        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        sentinel = object()

        def producer():
            try:
                for b in self._iter_batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item

    def _iter_multiprocess(self):
        """Real worker processes, reference ordering scheme: batch b is
        produced by worker b % num_workers; a reorder buffer keeps output
        in batch order while workers run ahead up to prefetch_factor."""
        import multiprocessing as mp
        # spawn, not fork: the parent holds live CUDA and torch threads,
        # which a forked child must not inherit. Workers do host-side
        # numpy only, so a fresh interpreter is right; dataset/collate_fn
        # must be picklable (the reference's spawn-mode rule). CUDA stays
        # invisible to them: a worker never touches the card.
        ctx = mp.get_context("spawn")
        nw = self.num_workers
        idx_queues = [ctx.Queue() for _ in range(nw)]
        out_queue = ctx.Queue(maxsize=nw * self.prefetch_factor)
        # workers collate to numpy; Tensor wrapping happens on this side
        worker_collate = (numpy_collate_fn
                          if self.collate_fn is default_collate_fn
                          else self.collate_fn)
        wrap = (self.collate_fn is default_collate_fn)
        workers = [
            ctx.Process(
                target=_worker_loop,
                args=(self.dataset, worker_collate, idx_queues[w], out_queue,
                      self._worker_init_fn, w, nw),
                daemon=True)
            for w in range(nw)
        ]
        # the children inherit this environment: no card for them, even
        # while unpickling their arguments
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for p in workers:
                p.start()
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        batches = list(self.batch_sampler)
        try:
            # prime and stream the index queues
            for b, idxs in enumerate(batches):
                idx_queues[b % nw].put((b, idxs))
            for q in idx_queues:
                q.put(None)  # per-worker end marker
            buffer = {}
            next_out = 0
            n = len(batches)
            while next_out < n:
                try:
                    kind, payload = out_queue.get(timeout=5.0)
                except queue.Empty:
                    # don't block forever on silently-dead workers (e.g. a
                    # spawn child that crashed before reaching the loop)
                    dead = [w for w, p in enumerate(workers)
                            if not p.is_alive() and p.exitcode != 0]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker(s) {dead} died with exit "
                            f"codes {[workers[w].exitcode for w in dead]}")
                    if all(not p.is_alive() for p in workers):
                        raise RuntimeError(
                            "DataLoader workers exited before producing all "
                            "batches")
                    continue
                if kind == "err":
                    raise RuntimeError(f"DataLoader worker failed: {payload}")
                if kind == "done":
                    continue
                b, batch = payload
                buffer[b] = _wrap_collated(batch) if wrap else batch
                while next_out in buffer:
                    yield buffer.pop(next_out)
                    next_out += 1
        finally:
            for p in workers:
                if p.is_alive():
                    p.terminate()
            for p in workers:
                p.join(5)
