"""The collective controller — counterpart of
``paddle_tpu/distributed/launch/controller.py``: build the job (one
trainer a local card, or ``--nproc_per_node`` CPU ranks), deploy the
pod, watch it, and restart. Elastic recovery is restart-based: a dead
trainer is restarted in place on one node; across nodes the pod stops,
re-rendezvouses at a new generation and redeploys. ``--max_restart``
bounds both kinds together; a job that gives up writes
``<log_dir>/failure.json`` with its reason.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, List

from .context import Context, reserve_ports
from .job import Job, Status, build_trainer_env
from .master import make_master

logger = logging.getLogger("paddle_tpu_torch.launch")


class CollectiveController:
    """One process per local card (or CPU rank), each with the PADDLE_*
    environment."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.job = Job(job_id=ctx.args.job_id)
        # Elastic jobs use a short rendezvous timeout so a node stuck in a
        # stale generation re-reads the counter and retries promptly.
        timeout_s = (float(ctx.args.elastic_timeout)
                     if ctx.args.elastic_level >= 1 else 120.0)
        self.master = make_master(ctx.args.master, ctx.node_ip,
                                  ctx.args.rank, ctx.args.job_id,
                                  ctx.is_multi_node, timeout_s=timeout_s)
        self.node_rank = ctx.args.rank
        self.gen = self.master.get_gen()
        #: the sockets holding this node's trainer ports (reserve_ports)
        self._held = []

    # -- job construction ---------------------------------------------------

    def build_job(self) -> None:
        ctx = self.ctx
        nproc = ctx.local_nproc
        # the local ports stay held until the next build or stop: worker
        # 0's is the trainers' rendezvous, bound by it (SO_REUSEADDR) when
        # it starts, and no other process can take it in between
        self._release_ports()
        ports, self._held = reserve_ports(nproc)
        local_eps = [f"{ctx.node_ip}:{p}" for p in ports]
        self.node_rank, peers = self.master.sync_peers(
            local_eps, ctx.args.rank, ctx.nnodes_min, ctx.nnodes_max,
            gen=self.gen)
        all_eps: List[str] = [ep for node in peers for ep in node]
        rank_offset = sum(len(peers[i]) for i in range(self.node_rank))
        world = len(all_eps)

        # Trainer rendezvous endpoint: worker 0's endpoint (its port is
        # free — reserved above — and on the master node for multi-node).
        master_ep = all_eps[0]

        script = ctx.args.training_script
        if script.endswith(".py"):
            entry_prefix = [sys.executable, "-u", script]
        else:
            entry_prefix = [script]

        if ctx.device == "cpu":
            devices = ["cpu"] * nproc
        else:
            devices = (ctx.args.devices.split(",") if ctx.args.devices
                       else [str(i) for i in range(nproc)])
        log_dir = ctx.args.log_dir
        self.job.pod.containers = []
        for i in range(nproc):
            rank = rank_offset + i
            env = build_trainer_env(
                rank, world, i, nproc, local_eps[i], all_eps, master_ep,
                node_rank=self.node_rank, job_id=ctx.args.job_id,
                restart_count=self.job.pod.restart_count,
                device=devices[i] if i < len(devices) else None)
            log_path = os.path.join(log_dir, f"workerlog.{rank}")
            self.job.pod.add_container(
                entry_prefix + ctx.args.training_script_args, env,
                log_path=log_path, rank=rank)

    # -- run loop -----------------------------------------------------------

    RESTART = "restart"

    def _fail(self, reason: str, **detail) -> Dict:
        """Record the structured reason the job is giving up: merged onto
        any container-level failure, logged as one JSON line, and written
        to ``<log_dir>/failure.json`` for supervisors to consume."""
        info: Dict = {"job_id": self.job.id, "node_rank": self.node_rank,
                      "gen": self.gen, "reason": reason}
        info.update(detail)
        if self.job.pod.failure:
            container = dict(self.job.pod.failure)
            container.pop("log_tail", None)  # keep the json line readable
            info["container"] = container
        self.job.failure = info
        logger.error("job failed: %s", json.dumps(info, default=str))
        log_dir = getattr(self.ctx.args, "log_dir", None)
        if log_dir:
            try:
                os.makedirs(log_dir, exist_ok=True)
                tmp = os.path.join(log_dir, "failure.json.tmp")
                with open(tmp, "w") as f:
                    json.dump(info, f, default=str, indent=2)
                os.replace(tmp, os.path.join(log_dir, "failure.json"))
            except OSError as e:
                logger.warning("could not write failure.json: %s", e)
        return info

    def _safe_get_gen(self) -> int:
        """Poll the generation counter; master loss reads as 'no change'
        (the hosting node may legitimately finish first)."""
        try:
            return self.master.get_gen()
        except Exception:
            return self.gen

    def run(self) -> int:
        ctx = self.ctx
        max_restart = ctx.args.max_restart if ctx.args.elastic_level >= 1 else 0
        restart_budget = max(max_restart, 1)
        while True:
            # Always rendezvous at the *latest* generation: concurrent bumps
            # from several failing nodes collapse to one namespace here.
            self.gen = max(self.gen, self._safe_get_gen())
            try:
                self.build_job()
            except (TimeoutError, RuntimeError, ConnectionError) as e:
                logger.error("rendezvous failed (gen %d): %s", self.gen, e)
                if max_restart == 0 or \
                        self.job.pod.restart_count >= restart_budget:
                    self._fail("rendezvous_failed", error=str(e))
                    self.master.close()
                    return 1
                # A failed rendezvous poisons its generation (half-written
                # counters/endpoints): bump so every node retries in a fresh
                # namespace — peers already deployed notice via their watch.
                try:
                    self.gen = self.master.bump_gen()
                except Exception:
                    pass
                self.job.pod.reset()
                time.sleep(1)
                continue
            logger.info("deploy pod: %d containers, node_rank=%d gen=%d",
                        len(self.job.pod.containers), self.node_rank, self.gen)
            self.job.pod.deploy()
            status = self.watch()
            if status == Status.COMPLETED:
                self.master.close()
                return 0
            if status == Status.FAILED:
                # local failure: report, and (elastic) tell peers via gen bump
                failed = [c for c in self.job.pod.containers
                          if c.status() == Status.FAILED]
                for c in failed:
                    logger.error("rank %d failed (exit %s); last log:\n%s",
                                 c.rank, c.exit_code, c.logs(tail=2048))
                # in-place peer restarts and full redeploys draw on the
                # same budget: --max_restart bounds total recovery attempts
                spent = (self.job.pod.restart_count +
                         self.job.pod.container_restarts)
                over_budget = spent >= max_restart
                if over_budget:
                    reason = (self.job.pod.failure or {}).get(
                        "reason", "container_failed")
                    self._fail(reason)
                if max_restart > 0:
                    try:
                        # signal peers even when leaving for good (scale-in)
                        self.master.bump_gen()
                    except Exception:
                        pass
                if over_budget:
                    self.job.pod.stop(force=True)
                    self.master.close()
                    return 1
            else:  # RESTART requested by a peer's gen bump
                if self.job.pod.restart_count >= restart_budget:
                    self._fail("pod_restart_budget_exhausted",
                               restart_budget=restart_budget)
                    self.job.pod.stop(force=True)
                    self.master.close()
                    return 1
            logger.warning("elastic restart %d/%d",
                           self.job.pod.restart_count + 1, restart_budget)
            self.job.pod.reset()     # bumps restart_count
            time.sleep(min(ctx.args.elastic_timeout, 3))

    def watch(self, poll_interval: float = 0.2) -> str:
        """Reference watcher loop: poll container liveness/exit codes.

        Elastic single-node: dead peers are restarted *in place* with
        exponential backoff (``Pod.restart_failed``) up to the
        ``max_restart`` budget — no re-rendezvous needed since endpoints
        are unchanged; past the budget the job fails with a structured
        reason. Multi-node elastic: also poll the store's generation
        counter — a peer node bumping it means the whole job is
        re-forming, so stop the local pod and re-rendezvous (reference:
        etcd membership watch).
        """
        ctx = self.ctx
        pod = self.job.pod
        elastic = ctx.args.elastic_level >= 1 and ctx.is_multi_node
        max_restart = (ctx.args.max_restart
                       if ctx.args.elastic_level >= 1 else 0)
        # In-place peer restart keeps every endpoint/env intact, so it is
        # only sound when there is no cross-node generation to re-form.
        in_place = max_restart > 0 and not ctx.is_multi_node
        last_gen_check = time.monotonic()
        while True:
            s = pod.status()
            if s == Status.COMPLETED:
                return s
            if s == Status.FAILED:
                if in_place and pod.restart_failed(max_restart):
                    logger.warning(
                        "restarted dead peers in place (%d/%d)",
                        pod.container_restarts, max_restart)
                    continue
                # budget spent (restart_failed recorded the reason) or
                # restarts disabled: tear down remaining live containers.
                # Only record here — run() may still recover via a full
                # elastic redeploy, and failure.json is a give-up artifact.
                if pod.failure is None:
                    pod.record_failure("container_failed")
                pod.stop(force=False)
                return s
            if elastic and time.monotonic() - last_gen_check >= 1.0:
                last_gen_check = time.monotonic()
                if self._safe_get_gen() != self.gen:
                    logger.warning("peer requested restart (gen changed)")
                    pod.stop(force=False)
                    return self.RESTART
            time.sleep(poll_interval)

    def _release_ports(self) -> None:
        for s in self._held:
            s.close()
        self._held = []

    def stop(self):
        self.job.pod.stop(force=True)
        self._release_ports()
        self.master.close()
