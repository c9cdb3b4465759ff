"""``paddle.distributed.spawn`` — counterpart of
``paddle_tpu/distributed/spawn.py``: starts ``nprocs`` Python processes
running ``func(*args)`` with the ``PADDLE_*`` environment the launch CLI
would give them (free local ports for the endpoints and the master,
held by the parent until the job ends, so no other process can take the
master port before rank 0 serves the rendezvous there), then joins
them.

Each process is one rank: it calls ``init_parallel_env()`` (NCCL on its
card ``PADDLE_LOCAL_RANK``, or ``device="cpu"`` for gloo). The default
start method is ``spawn``: a forked child cannot use CUDA.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Dict, Optional, Sequence

from .launch.context import reserve_ports
from .launch.job import build_trainer_env


class ProcessContext:
    def __init__(self, procs, *, held=()):
        self.processes = procs
        #: the sockets holding the job's ports, closed once it has ended
        self._held = list(held)

    def _release(self) -> None:
        for s in self._held:
            s.close()
        self._held = []

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join all workers. If any worker dies non-zero while siblings are
        still running, the survivors are terminated (they may be blocked on
        a rendezvous with the dead rank) and RuntimeError is raised —
        reference spawn behaviour. False when ``timeout`` passes first."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            alive = [p for p in self.processes if p.is_alive()]
            bad = [p for p in self.processes
                   if not p.is_alive() and p.exitcode != 0]
            if bad:
                for p in alive:
                    p.terminate()
                for p in alive:
                    p.join(5)
                self._release()
                raise RuntimeError(
                    f"{len(bad)} spawned process(es) failed with exit codes "
                    f"{[p.exitcode for p in bad]}")
            if not alive:
                self._release()
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            alive[0].join(0.2)

    def terminate(self) -> None:
        """Stop every worker still running."""
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(5)
        self._release()


def _worker(func, i: int, args, env: Dict[str, str]):
    os.environ.update(env)
    func(*args)


def spawn(func, args: Sequence = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, env: Optional[Dict[str, str]] = None,
          **options) -> ProcessContext:
    ports, held = reserve_ports(nprocs + 1)
    eps = [f"127.0.0.1:{p}" for p in ports[:nprocs]]
    master = f"127.0.0.1:{ports[-1]}"
    ctx = mp.get_context(options.get("start_method", "spawn"))
    procs = []
    for i in range(nprocs):
        child_env = build_trainer_env(i, nprocs, i, nprocs, eps[i], eps,
                                      master)
        if env:
            child_env.update(env)
        p = ctx.Process(target=_worker, args=(func, i, tuple(args), child_env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    pc = ProcessContext(procs, held=held)
    if join:
        pc.join()
    return pc
