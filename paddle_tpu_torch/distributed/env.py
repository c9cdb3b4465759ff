"""The process environment of ``paddle_tpu/distributed/env.py``, for one
process: rank and world size come from the reference's launcher
variables (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``; rank 0 of 1
without them), as its ``get_rank``/``get_world_size`` read them
(l.85-92). ``init_parallel_env`` over more than one process is the
distributed slice's (``torch.distributed`` over NCCL or gloo) and
raises."""

from __future__ import annotations

import os
from typing import Optional

from ..ops._common import not_ported

_initialized = [False]


def init_parallel_env(strategy=None, timeout_s: Optional[int] = None
                      ) -> "ParallelEnv":
    if _initialized[0]:
        return ParallelEnv()
    if get_world_size() > 1:
        raise not_ported("init_parallel_env over more than one process",
                         "distributed")
    _initialized[0] = True
    return ParallelEnv()


def is_initialized() -> bool:
    return _initialized[0]


def get_rank() -> int:
    """Process rank (reference: trainer id)."""
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size() -> int:
    """Number of processes (reference: trainer count)."""
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def device_count() -> int:
    import torch
    return torch.cuda.device_count()


class ParallelEnv:
    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", "0"))

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def dev_id(self) -> int:
        return self.local_rank
