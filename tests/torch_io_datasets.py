"""Datasets for tests/test_torch_io.py's worker processes. Spawned
workers unpickle them, so this module imports numpy and the port's
``io`` only: a worker that loads it must not load JAX, the JAX package
or torch."""

import sys

import numpy as np

from paddle_tpu_torch import io

#: modules a worker reports having loaded
WATCHED = ("jax", "paddle_tpu", "torch")


class SquareDataset(io.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.asarray([i * i], np.float32)

    def __len__(self):
        return self.n


class BoomDataset(io.Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom")
        return np.asarray([i], np.float32)

    def __len__(self):
        return 8


class ModulesDataset(io.Dataset):
    """Item ``i``: ``[i, whether each of WATCHED is loaded here]``."""

    def __getitem__(self, i):
        return np.asarray([i] + [m in sys.modules for m in WATCHED],
                          np.int32)

    def __len__(self):
        return 4


def init_fn(worker_id):
    # runs inside the worker process: get_worker_info works there
    info = io.get_worker_info()
    assert info is not None and info.id == worker_id
