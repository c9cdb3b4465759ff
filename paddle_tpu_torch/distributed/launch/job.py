"""Launch jobs — counterpart of ``paddle_tpu/distributed/launch/job.py``:
:func:`build_trainer_env` (the ``PADDLE_*`` contract every trainer
process receives, shared with ``spawn``) and the process model: a
``Container`` is one trainer subprocess with its environment and its
per-rank log file (``workerlog.N``), a ``Pod`` the node's containers
(with in-place restarts of dead ones), a ``Job`` the pod and the job's
recorded failure.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Dict, List, Optional


def build_trainer_env(rank: int, world: int, local_rank: int, local_size: int,
                      endpoint: str, all_endpoints: List[str], master: str,
                      node_rank: int = 0, job_id: str = "default",
                      restart_count: int = 0,
                      device: Optional[str] = None) -> Dict[str, str]:
    """The PADDLE_* env every trainer process receives — shared by the
    launch CLI and ``spawn`` so the two cannot drift. ``device`` is the
    card id (``FLAGS_selected_devices``; ``"cpu"`` runs the trainer on
    the CPU), the local rank by default."""
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(local_size),
        "PADDLE_NODE_RANK": str(node_rank),
        "PADDLE_CURRENT_ENDPOINT": endpoint,
        "PADDLE_TRAINER_ENDPOINTS": ",".join(all_endpoints),
        "PADDLE_MASTER": master,
        "PADDLE_JOB_ID": job_id,
        "PADDLE_RESTART_COUNT": str(restart_count),
        "FLAGS_selected_devices": device if device is not None else str(local_rank),
    }


class Status:
    UNINIT = "uninit"
    READY = "ready"
    RUNNING = "running"
    FAILED = "failed"
    TERMINATING = "terminating"
    COMPLETED = "completed"


class Container:
    """One trainer subprocess + env + log redirection."""

    def __init__(self, entrypoint: List[str], env: Dict[str, str],
                 log_path: Optional[str] = None, rank: int = -1):
        self.entrypoint = entrypoint
        self.env = env
        self.log_path = log_path
        self.rank = rank
        self.proc: Optional[subprocess.Popen] = None
        self._log_fh = None

    def start(self) -> None:
        env = dict(os.environ)
        env.update(self.env)
        stdout = stderr = None
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
            self._log_fh = open(self.log_path, "ab", buffering=0)
            stdout = stderr = self._log_fh
        self.proc = subprocess.Popen(self.entrypoint, env=env,
                                     stdout=stdout, stderr=stderr)

    def restart(self) -> None:
        """Relaunch this container in place (same entrypoint/endpoint; env
        may have been updated, e.g. PADDLE_RESTART_COUNT). The log file is
        reopened in append mode so both generations' output survives."""
        self.terminate(force=True)
        self.proc = None
        self.start()

    @property
    def exit_code(self) -> Optional[int]:
        return self.proc.poll() if self.proc else None

    def status(self) -> str:
        if self.proc is None:
            return Status.UNINIT
        code = self.proc.poll()
        if code is None:
            return Status.RUNNING
        return Status.COMPLETED if code == 0 else Status.FAILED

    def terminate(self, force: bool = False) -> None:
        if self.proc is None or self.proc.poll() is not None:
            self._close_log()
            return
        self.proc.send_signal(signal.SIGKILL if force else signal.SIGTERM)
        try:
            self.proc.wait(timeout=8)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._close_log()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def _close_log(self):
        if self._log_fh is not None:
            try:
                self._log_fh.close()
            finally:
                self._log_fh = None

    def logs(self, tail: int = 4096) -> str:
        if not self.log_path or not os.path.exists(self.log_path):
            return ""
        with open(self.log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - tail))
            return f.read().decode(errors="replace")


class Pod:
    """The set of local containers on this node (reference Pod)."""

    def __init__(self, name: str = ""):
        self.name = name or f"pod-{os.getpid()}"
        self.containers: List[Container] = []
        self.restart_count = 0           # full pod re-deployments
        self.container_restarts = 0      # in-place dead-peer restarts
        self.failure: Optional[Dict] = None  # structured give-up reason

    def add_container(self, entrypoint, env, log_path=None, rank=-1):
        self.containers.append(Container(entrypoint, env, log_path, rank))

    def failed_containers(self) -> List[Container]:
        return [c for c in self.containers if c.status() == Status.FAILED]

    def record_failure(self, reason: str, **detail) -> Dict:
        """Build + store the structured reason the job is giving up."""
        info: Dict = {"reason": reason, "pod": self.name,
                      "pod_restarts": self.restart_count,
                      "container_restarts": self.container_restarts}
        info.update(detail)
        failed = self.failed_containers()
        if failed:
            c = failed[0]
            info.setdefault("rank", c.rank)
            info.setdefault("exit_code", c.exit_code)
            info.setdefault("log_tail", c.logs(tail=1024))
        self.failure = info
        return info

    def restart_failed(self, max_restarts: int, backoff_base: float = 0.5,
                       backoff_cap: float = 8.0, sleep=time.sleep) -> bool:
        """Restart dead containers in place with exponential backoff.

        Returns True when the dead peers were relaunched (budget left) and
        False when the restart budget is spent — in which case a structured
        failure reason is recorded on ``self.failure``. Restarted
        containers see a bumped ``PADDLE_RESTART_COUNT`` so trainers can
        tell generations apart (e.g. to resume from a checkpoint).
        """
        failed = self.failed_containers()
        if not failed:
            return True
        if self.container_restarts >= max_restarts:
            self.record_failure("restart_budget_exhausted",
                                max_restarts=max_restarts)
            return False
        delay = min(backoff_base * (2 ** self.container_restarts),
                    backoff_cap)
        sleep(delay)
        self.container_restarts += 1
        gen = self.restart_count + self.container_restarts
        for c in failed:
            c.env["PADDLE_RESTART_COUNT"] = str(gen)
            c.restart()
        return True

    def deploy(self) -> None:
        for c in self.containers:
            c.start()

    def status(self) -> str:
        stats = [c.status() for c in self.containers]
        if any(s == Status.FAILED for s in stats):
            return Status.FAILED
        if any(s == Status.RUNNING for s in stats):
            return Status.RUNNING
        if stats and all(s == Status.COMPLETED for s in stats):
            return Status.COMPLETED
        return Status.UNINIT

    def join(self, poll_interval: float = 0.2) -> str:
        """Block until every container exits or one fails."""
        while True:
            s = self.status()
            if s in (Status.FAILED, Status.COMPLETED):
                return s
            time.sleep(poll_interval)

    def stop(self, force: bool = False) -> None:
        for c in self.containers:
            c.terminate(force=force)

    def reset(self) -> None:
        """Drop dead containers so the pod can be rebuilt for a restart.
        The recorded failure is per-generation (a recovered job must not
        carry a stale reason forward), but ``container_restarts`` is
        cumulative — in-place and full-redeploy restarts share one
        ``max_restart`` budget, never multiply it."""
        self.stop(force=True)
        self.containers = []
        self.restart_count += 1
        self.failure = None


class Job:
    def __init__(self, job_id: str = "default"):
        self.id = job_id
        self.pod = Pod()
        self.failure: Optional[Dict] = None  # structured give-up reason
