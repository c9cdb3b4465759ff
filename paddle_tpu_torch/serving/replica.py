"""One engine replica inside a router fleet — counterpart of
``paddle_tpu/serving/replica.py``.

A :class:`ReplicaHandle` bundles everything the
:class:`~paddle_tpu_torch.serving.router.FleetRouter` needs to own about a
single ``ContinuousBatchingEngine``: its :class:`~.scheduler.
ServingScheduler` (admission, retry, streaming), a per-replica
:class:`~.health.HealthTracker` (the circuit breaker the router drives),
the replica's share of the fleet metrics (its scheduler metrics register
under ``paddle_serving_r<id>``), and a deterministic chaos surface.

The chaos surface is how router chaos tests stay reproducible without
real crashes or real hangs:

* :meth:`kill` — every subsequent :meth:`step` raises
  :class:`ReplicaFault` before touching the engine (a dead replica);
* :meth:`stall` — steps raise for a wall-clock window on the injected
  clock (a hung step after the watchdog flags it), then recover;
* :meth:`slow` — steps sleep extra for a window (a straggler), then
  recover.

Faults raise *before* the scheduler runs, so the replica's engine state
stays coherent: in-flight sequences freeze rather than tear, which is
exactly what lets the router cancel + fail them over and lets a stalled
replica resume cleanly after re-admission.

Everything the router (or an operator surface) consumes is public —
``submit``/``cancel``/``step``, ``statusz()``, ``queue_depth``/
``inflight``/``pending``, ``health``, ``draining``. The scheduler and
fault cell are private: nothing outside ``serving/`` reaches into them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from .health import HealthConfig, HealthTracker
from .metrics import ServingMetrics
from .scheduler import SchedulerConfig, ServingRequest, ServingScheduler


class ReplicaFault(RuntimeError):
    """Injected replica-level failure (chaos: die / stall)."""


class ReplicaHandle:
    """See module docstring."""

    def __init__(self, replica_id: int, engine,
                 config: Optional[SchedulerConfig] = None,
                 health_config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.replica_id = int(replica_id)
        self.engine = engine
        self._clock = clock
        self._sleep = sleep
        self._scheduler = ServingScheduler(
            engine, config,
            metrics=ServingMetrics(
                namespace=f"paddle_serving_r{self.replica_id}"),
            clock=clock, sleep=sleep)
        self.health = HealthTracker(health_config, clock=clock)
        spec = getattr(engine, "spec", None)
        if spec is not None:
            # stamp the replica id into the engine's paddle_spec_* label
            # so fleet-wide speculation metrics split per replica
            spec.replica = str(self.replica_id)
        self.draining = False
        self.drained_event_sent = False     # router's once-only latch
        self._fault: Optional[tuple] = None  # ("die",) | ("stall", t_end)
        #                                    # | ("slow", t_end, delay_s)

    # -- request lifecycle (delegated to the scheduler) ---------------------

    def submit(self, prompt, priority: int = 0,
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               defer_s: Optional[float] = None,
               no_shed: bool = False,
               trace_id: Optional[str] = None,
               sampler: Any = None,
               grammar: Any = None,
               grammar_prefix: Any = None, *,
               decoded: int = 0) -> ServingRequest:
        return self._scheduler.submit(
            prompt, priority=priority, deadline_ms=deadline_ms,
            max_new_tokens=max_new_tokens, on_token=on_token,
            defer_s=defer_s, no_shed=no_shed, trace_id=trace_id,
            sampler=sampler, grammar=grammar,
            grammar_prefix=grammar_prefix, decoded=decoded)

    def cancel(self, rid: int) -> bool:
        return self._scheduler.cancel(rid)

    def step(self, params) -> int:
        """One scheduler round — after the chaos gate. Dead/stalled
        replicas raise :class:`ReplicaFault` here (the router records
        the failure); slow replicas pay their extra latency first."""
        f = self._fault
        if f is not None:
            kind = f[0]
            if kind == "die":
                raise ReplicaFault(
                    f"replica {self.replica_id} is dead")
            if kind == "stall":
                if self._clock() < f[1]:
                    raise ReplicaFault(
                        f"replica {self.replica_id} step stalled past "
                        "the watchdog")
                self._fault = None
            elif kind == "slow":
                if self._clock() < f[1]:
                    self._sleep(f[2])
                else:
                    self._fault = None
        return self._scheduler.step(params)

    # -- router-facing state ------------------------------------------------

    @property
    def default_max_new_tokens(self) -> int:
        return self.engine.config.max_new_tokens

    @property
    def pending(self) -> int:
        """Unresolved requests on this replica (incl. deferred backoff)."""
        return self._scheduler.pending

    @property
    def active(self) -> int:
        """Requests a step can progress right now (queued or decoding)."""
        return self._scheduler.active

    @property
    def inflight(self) -> int:
        return self._scheduler.inflight

    @property
    def queue_depth(self) -> int:
        return self._scheduler.queue_depth

    @property
    def progress_marker(self) -> tuple:
        """Changes whenever the replica does useful work (tokens
        generated, requests completed, active-work level). The router
        refreshes the health watchdog only when this moves while busy —
        a wedged replica whose steps return without serving anything
        still trips the watchdog."""
        c = self._scheduler.metrics.counters
        return (c.get("tokens_generated_total", 0),
                c.get("requests_completed_total", 0),
                self._scheduler.active)

    @property
    def degraded(self) -> bool:
        """The scheduler spent its retry budget: this replica needs a
        fresh engine + handle (``FleetRouter.replace_replica``)."""
        return self._scheduler.degraded

    @property
    def slo_monitor(self):
        return self._scheduler.slo_monitor

    def make_slo_monitor(self, **kw):
        """Per-replica SLOs (see ``ServingScheduler.make_slo_monitor``);
        the router folds the monitor's health into routing weights."""
        return self._scheduler.make_slo_monitor(**kw)

    def statusz(self) -> Dict[str, Any]:
        """The scheduler's live view plus replica identity, breaker
        state and chaos status — one entry of the router's fleet view."""
        out = self._scheduler.statusz()
        out["replica_id"] = self.replica_id
        out["health"] = self.health.snapshot()
        out["draining"] = self.draining
        if self._fault is not None:
            out["injected_fault"] = self._fault[0]
        return out

    def journal_spec(self) -> Dict[str, Any]:
        """This replica's slice of a journal head frame: the exact
        constructor geometry postmortem replay
        (``paddle_tpu/observability/replay.py``) needs to rebuild an
        identical engine + scheduler + breaker.
        Lives here (not in replay) so the journal never reaches into
        ``._scheduler``/``._fault`` from outside ``serving/``."""
        from dataclasses import asdict
        eng = self.engine
        return {
            "replica_id": self.replica_id,
            "engine": {
                "num_slots": eng.num_slots,
                "page_size": eng.page_size,
                "chunk": eng.chunk,
                "max_seq_len": eng.max_seq_len,
                "num_pages": eng.mgr.num_pages,
                "prefix_cache": eng.cache is not None,
                "speculative": eng._speculative,
                "spec_k": eng.spec_k,
                "unified": eng._unified,
                # beyond the JAX package's frame: the packed axis decides
                # which step a prompt token rides (and, on the card, how
                # a GEMM rounds), so replay needs it
                "step_tokens": eng._step_tokens,
            },
            "generation": asdict(eng.config),
            "scheduler": asdict(self._scheduler.config),
            "health": asdict(self.health.config),
        }

    # -- chaos surface (deterministic fault injection) ----------------------

    def kill(self) -> None:
        """Permanent death: every later step raises. Only
        ``FleetRouter.replace_replica`` brings the slot back."""
        self._fault = ("die",)

    def stall(self, duration_s: float) -> None:
        """Steps raise until ``duration_s`` passes on the injected
        clock, then the replica serves again (the re-admission path)."""
        self._fault = ("stall", self._clock() + float(duration_s))

    def slow(self, duration_s: float, delay_s: float) -> None:
        """Each step sleeps ``delay_s`` extra until ``duration_s``
        passes — a straggler the load-aware router routes around."""
        self._fault = ("slow", self._clock() + float(duration_s),
                       float(delay_s))
