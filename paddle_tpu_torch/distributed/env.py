"""The process environment — counterpart of
``paddle_tpu/distributed/env.py``.

Rank and world size come from the reference's launcher variables
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``; rank 0 of 1 without
them), or from the initialised process group. ``init_parallel_env``
starts ``torch.distributed`` at :func:`coordinator_address`, the
reference's order of variables: NCCL on the card (the default; the
process takes card ``PADDLE_LOCAL_RANK``), gloo when the caller asks
for the CPU (``device="cpu"``, or ``FLAGS_selected_devices=cpu`` from
the launcher's ``--devices cpu``). One process with no coordinator in its
environment starts no process group, as the reference starts no
coordination service there: the collectives are then identities on
the one rank.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

_initialized = [False]

_COORDINATOR_VARS = ("PADDLE_MASTER", "PADDLE_TRAINER_ENDPOINTS",
                     "MASTER_ADDR", "MASTER_PORT")


def coordinator_address() -> str:
    """Where rank 0 serves the rendezvous: ``PADDLE_MASTER``, else the
    FIRST entry of ``PADDLE_TRAINER_ENDPOINTS`` (the launcher deploys
    rank 0 there), else ``MASTER_ADDR``:``MASTER_PORT``."""
    master = os.environ.get("PADDLE_MASTER")
    if master:
        return master
    endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    if endpoints:
        first = endpoints.split(",")[0].strip()
        if first:
            return first
    return (os.environ.get("MASTER_ADDR", "127.0.0.1") + ":" +
            os.environ.get("MASTER_PORT", "8639"))


def distributed_is_initialized() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def init_parallel_env(strategy=None, timeout_s: Optional[int] = None, *,
                      device=None) -> "ParallelEnv":
    """Parity with ``paddle.distributed.init_parallel_env``: joins this
    process (``PADDLE_TRAINER_ID`` of ``PADDLE_TRAINERS_NUM``) to the
    job's process group at :func:`coordinator_address` and returns once
    every rank has joined. ``device``: ``None`` means the card (NCCL,
    raising without one) unless the launcher selected the CPU
    (``FLAGS_selected_devices=cpu``), ``"cpu"`` gloo."""
    if _initialized[0]:
        return ParallelEnv()
    nprocs = get_world_size()
    wanted = nprocs > 1 or any(os.environ.get(v) for v in _COORDINATOR_VARS)
    if wanted and not distributed_is_initialized():
        import torch
        import torch.distributed as dist

        from ..ops._common import resolve_device
        if device is None and os.environ.get(
                "FLAGS_selected_devices") == "cpu":
            device = "cpu"
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(ParallelEnv().dev_id)
        rank = get_rank()
        master = coordinator_address()
        kwargs = {}
        if timeout_s is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
        try:
            dist.init_process_group(backend, init_method=f"tcp://{master}",
                                    world_size=nprocs, rank=rank, **kwargs)
            atexit.register(_destroy_at_exit)
        except Exception as e:
            raise RuntimeError(
                f"multi-process bring-up failed: rank {rank}/{nprocs} could "
                f"not reach coordinator {master!r} "
                f"(PADDLE_MASTER/PADDLE_TRAINER_ENDPOINTS). "
                f"Original error: {type(e).__name__}: {e}") from e
    _initialized[0] = True
    return ParallelEnv()


def _destroy_at_exit() -> None:
    """Tear down a process group the program left up: gloo's threads
    abort the interpreter's exit otherwise."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return _initialized[0]


def get_rank() -> int:
    """Process rank (reference: trainer id)."""
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env is not None:
        return int(env)
    if distributed_is_initialized():
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def get_world_size() -> int:
    """Number of processes (reference: trainer count)."""
    env = os.environ.get("PADDLE_TRAINERS_NUM")
    if env is not None:
        return int(env)
    if distributed_is_initialized():
        import torch.distributed as dist
        return dist.get_world_size()
    return 1


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
