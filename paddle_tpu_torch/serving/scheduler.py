"""SLO-aware request scheduler over the continuous-batching engine —
counterpart of ``paddle_tpu/serving/scheduler.py``.

The engine (`paddle_tpu_torch.inference.decoding.ContinuousBatchingEngine`) is a
closed batch loop: fixed decode slots, its own FIFO, one compiled decode
chunk per round. This module adds the request lifecycle a serving runtime
needs on top of it:

* **admission queue** — priority classes (lower number = more urgent),
  FIFO within a class, per-request ``deadline_ms`` and
  ``max_new_tokens``;
* **load shedding** — when queue depth exceeds ``max_queue_depth`` the
  victim is the *lowest-priority, latest-deadline* queued request (a
  no-deadline request sheds before any deadlined peer in the same
  class); queued requests whose deadline lapses before admission are
  shed as ``deadline``;
* **cancellation** — queued or mid-decode; a live cancel retires the
  engine slot immediately and returns its pages to the pool; a request
  parked on the retry/backoff path (``submit(defer_s=...)`` — the fleet
  router's failover resubmissions) cancels idempotently: a later
  promotion tick can never resurrect it;
* **robustness** — optional per-step wall-clock timeout and bounded
  retry-with-exponential-backoff around ``engine.step``; after the retry
  budget is spent the scheduler *degrades gracefully*: every in-flight
  and queued request is drained with a structured
  :class:`~paddle_tpu_torch.serving.stream.ServingError` instead of the loop
  crashing;
* **streaming** — tokens are pushed into each request's
  :class:`~paddle_tpu_torch.serving.stream.TokenStream` as the engine unpacks
  each decode chunk (via the engine's ``token_callback``), so consumers
  see tokens at chunk cadence rather than at final ``collect()``;
* **metrics** — TTFT/ITL/e2e/queue-wait histograms, queue-depth and
  slot/page-utilization samples, shed/cancel/retry counters, plus
  profiler ``RecordEvent`` spans (``paddle_serving.step`` etc.) so
  scheduler phases correlate with device activity in traces;
* **SLOs** — :meth:`ServingScheduler.make_slo_monitor` attaches a
  multi-window burn-rate monitor over the scheduler's own metrics and
  clock; ``step()`` ticks it once per round and a breach sheds part of
  the admission queue through the existing shedding policy (reason
  ``slo``). ``statusz()`` is the diagnostics server's live view, and
  the flight recorder auto-dumps a debug bundle on watchdog timeouts
  and degradation.

On the card (the port's engine steps through CUDA graphs): the step
watchdog runs ``engine.step`` on its own thread, on the caller's device
and current stream, so a replay there orders after what the caller
queued; a program that step builds is captured in that thread
(``inference.graphs`` captures thread-locally, so the caller's own CUDA
work during the capture cannot break it). A build is part of the timed
attempt, as a jit compile is in the JAX package: under a timeout
shorter than the build, the attempt times out and the retry waits on the
straggler, whose completion counts as the step. ``attach_signal_bus``
waits for the port of ``observability.signals``.

Determinism: scheduling order depends only on (priority, arrival order)
and on deadline comparisons against the injected ``clock``; with a fixed
engine seed and a deterministic clock, outputs are reproducible.

Typical single-threaded driving loop::

    sched = ServingScheduler(engine)
    h = sched.submit(prompt, priority=0, deadline_ms=500,
                     on_token=print)
    while sched.pending:
        sched.step(params)
    print(h.stream.result(), sched.metrics.to_prometheus_text())
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..observability.events import emit_event
from ..observability.flight import flight_recorder
from ..observability.journal import journal, journal_armed
from ..observability.memory import (memory_armed, memory_ledger,
                                    pool_occupancy)
from ..observability.step_timer import StepTimer
from ..observability.timeline import span_collector, timeline_armed
from ..observability.timeseries import history_armed
from ..observability.trace import new_trace_id, trace_context
from ..ops._common import not_ported, stream_scope
from ..profiler.record import emit_span, emit_spans, make_span, spans_armed
from .metrics import ServingMetrics
from .stream import ServingError, TokenStream


class RequestState:
    """Lifecycle states of a :class:`ServingRequest`."""

    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"
    SHED = "shed"
    FAILED = "failed"


@dataclass
class SchedulerConfig:
    """Scheduler knobs.

    ``max_queue_depth``: admission-queue cap; beyond it the scheduler
    sheds lowest-priority-latest-deadline first.
    ``step_timeout_s``: optional wall-clock budget per ``engine.step``;
    the step runs on a watchdog thread and a timeout counts as a failure
    (the hung attempt itself cannot be interrupted — on real hangs the
    retries exhaust and the scheduler degrades). Two engine steps never
    run concurrently: while a timed-out attempt is still executing,
    retries wait on it instead of launching a second step, and a slow
    attempt that eventually completes counts as the step.
    ``max_step_retries``: failed steps are retried this many times with
    exponential backoff (``retry_backoff_s * retry_backoff_multiplier**i``)
    before the scheduler degrades.
    """

    max_queue_depth: int = 64
    step_timeout_s: Optional[float] = None
    max_step_retries: int = 3
    retry_backoff_s: float = 0.05
    retry_backoff_multiplier: float = 2.0


@dataclass
class ServingRequest:
    """Handle for one submitted request (returned by ``submit``)."""

    rid: int
    prompt: np.ndarray
    priority: int = 0
    deadline_ms: Optional[float] = None
    max_new_tokens: Optional[int] = None
    stream: TokenStream = None
    state: str = RequestState.QUEUED
    engine_rid: Optional[int] = None
    submit_t: float = 0.0
    deadline_t: Optional[float] = None    # absolute, scheduler clock
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    trace_id: str = ""                    # minted at submit; follows the
    sampler: Any = None                   # SamplerConfig (None = engine
    grammar: Any = None                   # default); TokenDFA constraint
    grammar_prefix: Any = None            # already-emitted tokens to
    # pre-advance the grammar through (failover continuations: the
    # streamed tokens became prompt, so the DFA must resume mid-string)
    token_checksum: Optional[int] = None  # crc32 of the engine-retired
    # tokens, stamped at finish — the journal's engine-side twin of the
    # router's stream checksum (a mismatch localizes divergence to the
    # stream plumbing rather than the decode loop)
    _span: Any = field(default=None, repr=False)  # request across layers
    _submit_ns: int = field(default=0, repr=False)  # perf-clock twin of
    # submit_t (submit_t may come from an injected/fake scheduler clock;
    # trace spans need the real perf_counter_ns timeline)
    _ready_t: float = field(default=0.0, repr=False)   # deferred requests
    _key: tuple = field(default=(), repr=False)        # (priority, seq)
    _no_shed: bool = field(default=False, repr=False)  # remediation: never
    # a queue-cap/SLO shed victim (deadlines still apply)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED,
                              RequestState.SHED, RequestState.FAILED)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.submit_t) * 1e3


class ServingScheduler:
    """Priority/deadline-aware admission + robust step loop over a
    ``ContinuousBatchingEngine`` (see module docstring)."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None,
                 metrics: Optional[ServingMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.engine = engine
        self.config = config or SchedulerConfig()
        self.metrics = metrics or ServingMetrics()
        self._clock = clock
        self._sleep = sleep
        self._next_rid = 0
        self._seq = 0                       # FIFO tiebreak within priority
        self._queue: List[ServingRequest] = []   # sorted by (priority, seq)
        self._order: List[tuple] = []            # parallel (priority, seq)
        # deferred admissions (retry/backoff): requests parked here until
        # the clock passes their _ready_t, then promoted into the queue
        # at their original (priority, seq) position
        self._backoff: List[ServingRequest] = []
        self._requests: Dict[int, ServingRequest] = {}
        self._by_engine_rid: Dict[int, ServingRequest] = {}
        self._watchdog: Optional[tuple] = None   # (thread, result box)
        self.step_timer = StepTimer()            # host/device + tokens/s
        # ONE reusable light step-span object: it wraps every scheduler
        # round, so re-building the RecordEvent (+ its namespace
        # f-string) per step would be standing armed-loop cost
        # (RecordEvent begin/end resets make sequential reuse safe)
        self._step_span = self.metrics.span("step", light=True)
        self.degraded = False
        self.slo_monitor = None                  # see attach_slo_monitor
        self.signal_bus = None                   # see attach_signal_bus
        self._slo_shed_fraction = 0.5
        # engine hooks: route chunk tokens / retirements into the streams
        engine.token_callback = self._on_engine_token
        engine.finish_callback = self._on_engine_finish

    def _engine_budget(self, max_new_tokens: Optional[int]) -> int:
        """Per-request new-token budget (override or engine default)."""
        return (max_new_tokens if max_new_tokens is not None
                else self.engine.config.max_new_tokens)

    # -- submission & cancellation ------------------------------------------

    def submit(self, prompt, priority: int = 0,
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               defer_s: Optional[float] = None,
               no_shed: bool = False,
               trace_id: Optional[str] = None,
               sampler: Any = None,
               grammar: Any = None,
               grammar_prefix: Any = None) -> ServingRequest:
        """Queue a request. ``priority`` is a class (0 = most urgent, FIFO
        within a class); ``deadline_ms`` is the admission SLO relative to
        now — a request still queued past it is shed; ``max_new_tokens``
        overrides the engine default budget; ``on_token`` streams tokens
        synchronously as chunks unpack. ``defer_s`` parks the request in
        the backoff area until the scheduler clock passes ``now +
        defer_s`` (the retry/backoff path: the fleet router resubmits
        failed-over requests this way); deferred requests keep their
        arrival (priority, FIFO) position, count toward ``pending``, can
        be cancelled, and expire against their deadline like any queued
        request — but are exempt from queue-cap and SLO shedding while
        parked AND after promotion (they are remediation, not fresh
        load; a full queue sheds fresh victims around them, never them).
        ``no_shed`` grants the same exemption to an immediate
        (non-deferred) submission — the router's drain handoffs.
        ``trace_id`` adopts an outer layer's trace identity (the fleet
        router mints one id per router request and passes it through
        every dispatch, failover resubmissions included, so the whole
        path assembles into ONE span tree); None mints a fresh id.
        ``sampler`` (a ``SamplerConfig``) and ``grammar`` (a
        ``TokenDFA``) ride the handle into the engine's in-program
        sampling epilogue; ``grammar_prefix`` pre-advances the grammar
        through tokens already emitted before a failover continuation.
        Returns the request handle (its
        ``.stream`` is the consumption surface). The handle may come back
        already shed if the queue cap evicts it immediately.

        Infeasible requests — prompt + budget beyond the engine's
        ``max_seq_len``, or needing more KV pages than the whole pool
        holds — raise ``ValueError`` here instead of being queued: they
        could never be admitted, and letting them reach the engine would
        either leak a never-closed stream or (for the page case) turn a
        permanent per-request error into repeated step failures that
        degrade the whole scheduler."""
        if self.degraded:
            raise ServingError(
                "engine_failure",
                "scheduler is degraded after repeated step failures; "
                "create a fresh engine+scheduler")
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + self._engine_budget(max_new_tokens)
        if total > self.engine.max_seq_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens + max_new_tokens="
                f"{self._engine_budget(max_new_tokens)} exceeds the "
                f"engine's max_seq_len={self.engine.max_seq_len}; raise "
                "max_seq_len or truncate the prompt")
        mgr = self.engine.mgr
        if mgr.pages_for(total) > mgr.usable_pages:
            raise ValueError(
                f"request of {total} total tokens needs "
                f"{mgr.pages_for(total)} KV pages but the engine pool "
                f"only holds {mgr.usable_pages}; enlarge num_pages or "
                "shrink the request")
        now = self._clock()
        rid = self._next_rid
        self._next_rid += 1
        req = ServingRequest(
            rid=rid, prompt=prompt,
            priority=int(priority), deadline_ms=deadline_ms,
            max_new_tokens=max_new_tokens,
            stream=TokenStream(rid, on_token=on_token),
            submit_t=now,
            deadline_t=None if deadline_ms is None
            else now + deadline_ms / 1e3,
            trace_id=trace_id or new_trace_id("req"),
            sampler=sampler, grammar=grammar,
            grammar_prefix=grammar_prefix)
        req._span = self.metrics.span("request",
                                      args={"request_id": rid},
                                      trace_id=req.trace_id)
        req._span.begin()
        # after begin(): the request envelope starts at or before every
        # phase span, so queue_wait nests inside it in the span tree
        req._submit_ns = time.perf_counter_ns()
        self._requests[rid] = req
        req._key = (req.priority, self._seq)
        self._seq += 1
        self.metrics.inc("requests_submitted_total")
        # deferred (failover) and explicitly-marked (drain handoff)
        # submissions are remediation traffic: exempt from queue-cap/SLO
        # shedding for good
        req._no_shed = bool(no_shed) or (defer_s is not None
                                         and defer_s > 0)
        if defer_s is not None and defer_s > 0:
            req._ready_t = now + defer_s
            self._backoff.append(req)
            return req
        self._enqueue(req)
        self._shed_overflow()
        return req

    def _enqueue(self, req: ServingRequest) -> None:
        i = bisect.bisect(self._order, req._key)
        self._order.insert(i, req._key)
        self._queue.insert(i, req)

    def _promote_backoff(self) -> None:
        """Move due deferred requests into the admission queue. A request
        cancelled (or otherwise finished) while parked here must NEVER be
        re-admitted by this tick — cancel() removes it from the backoff
        list, and the ``done`` filter catches any straggler reference."""
        if not self._backoff:
            return
        now = self._clock()
        due = [r for r in self._backoff
               if now >= r._ready_t and not r.done]
        self._backoff = [r for r in self._backoff
                         if now < r._ready_t and not r.done]
        for req in sorted(due, key=lambda r: r._key):
            self._enqueue(req)
        if due:
            self._shed_overflow()

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request; frees its engine slot and
        pages immediately when mid-decode. False if unknown/finished."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        if req.state == RequestState.QUEUED:
            if req in self._backoff:
                # parked on the retry/backoff path: removing it here is
                # what keeps cancel-after-retry idempotent — a later
                # promotion tick must not resurrect it
                self._backoff.remove(req)
            else:
                i = self._queue.index(req)
                self._queue.pop(i)
                self._order.pop(i)
        elif req.state == RequestState.RUNNING:
            self.engine.cancel(req.engine_rid)
            self._by_engine_rid.pop(req.engine_rid, None)
        self._finish(req, RequestState.CANCELLED, "cancelled")
        self.metrics.inc("requests_cancelled_total")
        self.metrics.mark("cancel")
        emit_event("cancel", request_id=req.rid, trace_id=req.trace_id)
        return True

    # -- SLO wiring ---------------------------------------------------------

    def make_slo_monitor(self, ttft_p95_ms: Optional[float] = None,
                         itl_p99_ms: Optional[float] = None,
                         max_shed_ratio: Optional[float] = 0.01,
                         **monitor_kw):
        """Build an :class:`~paddle_tpu_torch.observability.slo.SLOMonitor`
        over THIS scheduler's metrics sink and attach it: TTFT p95 /
        ITL p99 latency objectives (pass thresholds to enable) and a
        "submissions not shed or failed" ratio objective. Extra kwargs
        (windows, burn_threshold, clock) flow to the monitor; the
        scheduler's own clock is the default, so fake-clock tests stay
        deterministic end to end."""
        from ..observability.slo import (SLOMonitor, latency_objective,
                                         ratio_objective)
        m = self.metrics
        objectives = []
        if ttft_p95_ms is not None:
            objectives.append(latency_objective(
                "ttft", lambda: m.histograms["ttft_ms"], ttft_p95_ms,
                target=0.95))
        if itl_p99_ms is not None:
            objectives.append(latency_objective(
                "itl", lambda: m.histograms["itl_ms"], itl_p99_ms,
                target=0.99))
        if max_shed_ratio is not None:
            # exclude reason="slo" sheds: those are the monitor's OWN
            # remediation — counting them as bad events would let a
            # latency breach cascade into a self-inflicted shed breach
            objectives.append(ratio_objective(
                "shed", lambda: m.shed_total - m.shed.get("slo", 0.0)
                + m.counters.get("step_failures_total", 0),
                lambda: m.counters.get("requests_submitted_total", 0),
                target=1.0 - max_shed_ratio))
        if not objectives:
            raise ValueError("no objectives enabled; pass at least one "
                             "of ttft_p95_ms / itl_p99_ms / "
                             "max_shed_ratio")
        monitor_kw.setdefault("clock", self._clock)
        monitor = SLOMonitor(objectives, **monitor_kw)
        self.attach_slo_monitor(monitor)
        return monitor

    def attach_slo_monitor(self, monitor,
                           shed_fraction: float = 0.5) -> None:
        """Wire a monitor into the serving loop: ``step()`` ticks it
        once per round. The breach transition sheds ``shed_fraction``
        of the admission queue (worst victims first — the existing
        load-shedding policy), and for as long as the breach latch
        holds, every step keeps the queue capped at
        ``max_queue_depth * (1 - shed_fraction)`` so refilling traffic
        keeps being trimmed until the objective recovers."""
        self.slo_monitor = monitor
        self._slo_shed_fraction = float(shed_fraction)
        monitor.on_breach = self._on_slo_breach
        monitor.on_recover = self._on_slo_recover

    def attach_signal_bus(self, bus=None, **bus_kw):
        """Wire the sensor plane: a
        :class:`~paddle_tpu_torch.observability.signals.SignalBus` over THIS
        scheduler's queue/engine/SLO state, ticked once per step while
        the plane is armed (``timeseries.history_armed`` — one list
        index disarmed; the tick itself is decimated to the bus
        interval). ``bus=None`` builds one on the scheduler's own clock
        so fake-clock tests stay deterministic end to end. Not ported yet:
        raises ``NotImplementedError``."""
        raise not_ported("ServingScheduler.attach_signal_bus (the sensor "
                         "plane, observability.signals)",
                         "observability signals")

    def _on_slo_breach(self, name: str, state: dict) -> None:
        self.metrics.set_gauge("slo_breached", 1.0)
        self.metrics.mark("slo_breach")
        n_shed = int(len(self._queue) * self._slo_shed_fraction + 0.5)
        shed = 0
        for _ in range(n_shed):
            if not self._shed_worst("slo"):
                break       # only no-shed remediation requests remain
            shed += 1
        if shed:
            emit_event("slo_degrade_shed", slo=name, shed=shed,
                       queue_depth=len(self._queue))

    def _on_slo_recover(self, name: str, state: dict) -> None:
        if not self.slo_monitor.breached():
            self.metrics.set_gauge("slo_breached", 0.0)
        self.metrics.mark("slo_recovered")

    # -- queue policy -------------------------------------------------------

    def _shed_worst(self, reason: str) -> bool:
        """Shed one queued request: lowest priority class (max number),
        then latest deadline (None = +inf sheds first), then latest
        arrival. Remediation requests (``_no_shed`` — the router's
        failover resubmissions) are never victims; False when nothing
        sheddable remains."""
        def badness(iq):
            i, r = iq
            dl = float("inf") if r.deadline_t is None else r.deadline_t
            return (r.priority, dl, self._order[i][1])
        sheddable = [(i, r) for i, r in enumerate(self._queue)
                     if not r._no_shed]
        if not sheddable:
            return False
        i, victim = max(sheddable, key=badness)
        self._queue.pop(i)
        self._order.pop(i)
        self._shed(victim, reason)
        return True

    def _shed_overflow(self, cap: Optional[int] = None,
                       reason: str = "queue_full") -> None:
        if cap is None:
            cap = self.config.max_queue_depth
        while len(self._queue) > cap:
            if not self._shed_worst(reason):
                break       # only remediation left: cap soft-exceeded

    def _expire_deadlines(self) -> None:
        now = self._clock()
        keep_q, keep_o = [], []
        for req, key in zip(self._queue, self._order):
            if req.deadline_t is not None and now > req.deadline_t:
                self._shed(req, "deadline")
            else:
                keep_q.append(req)
                keep_o.append(key)
        self._queue, self._order = keep_q, keep_o
        if self._backoff:
            lapsed = [r for r in self._backoff
                      if r.deadline_t is not None and now > r.deadline_t]
            if lapsed:
                self._backoff = [r for r in self._backoff
                                 if r not in lapsed]
                for req in lapsed:
                    self._shed(req, "deadline")

    def _shed(self, req: ServingRequest, reason: str) -> None:
        self._finish(req, RequestState.SHED, f"shed:{reason}",
                     ServingError(f"shed_{reason}",
                                  f"request {req.rid} shed ({reason})",
                                  rid=req.rid))
        self.metrics.inc_shed(reason)
        self.metrics.mark(f"shed.{reason}")
        emit_event("shed", reason=reason, request_id=req.rid,
                   trace_id=req.trace_id, priority=req.priority)

    def _finish(self, req: ServingRequest, state: str, reason: str,
                error: Optional[ServingError] = None) -> None:
        req.state = state
        req.finish_t = self._clock()
        if (req.engine_rid is None and req._submit_ns
                and spans_armed()):
            # never admitted (queue-cap/SLO/deadline shed, queued
            # cancel): its whole life WAS queue wait — emit the segment
            # retroactively so the timeline attributes the shed latency
            emit_span(f"{self.metrics.namespace}.queue_wait",
                      req._submit_ns, time.perf_counter_ns(),
                      trace_id=req.trace_id,
                      args={"request_id": req.rid})
        req.stream.close(reason, error)
        if req._span is not None:
            req._span.end()
            req._span = None
        # evict from the registry or a long-running server leaks every
        # prompt/stream ever submitted; the caller keeps the handle
        self._requests.pop(req.rid, None)

    # -- the serving loop ---------------------------------------------------

    @property
    def pending(self) -> int:
        """Requests still queued, parked in backoff, or mid-decode."""
        return (len(self._queue) + len(self._backoff)
                + len(self._by_engine_rid))

    @property
    def active(self) -> int:
        """Requests the engine can make progress on THIS step (queued or
        mid-decode; deferred backoff requests excluded)."""
        return len(self._queue) + len(self._by_engine_rid)

    @property
    def queue_depth(self) -> int:
        """Admission pressure: queued + deferred-backoff requests (the
        fleet router's per-decision load signal — O(1), unlike the full
        ``statusz()`` document)."""
        return len(self._queue) + len(self._backoff)

    @property
    def inflight(self) -> int:
        """Requests currently decoding in engine slots."""
        return len(self._by_engine_rid)

    def step(self, params) -> int:
        """One scheduler round: expire deadlines, admit into free slots,
        run a robust engine step, account. Returns ``pending``.

        Ordinary engine exceptions stay inside the retry/degrade
        machinery; a non-``Exception`` ``BaseException`` (KeyboardInterrupt,
        SystemExit, a fatal runtime death) would otherwise fly past it
        and leave every consumer stream blocked forever — those drain the
        scheduler (terminal errors on every stream) and re-raise."""
        if self.degraded:
            return 0
        try:
            self._step_inner(params)
        except BaseException as e:
            if not isinstance(e, Exception):
                self._degrade(e)
            raise
        return self.pending

    def _step_inner(self, params) -> None:
        # each scheduler round gets its own trace id, so the step's op
        # dispatches correlate in the chrome trace (per-request lanes use
        # the request trace ids minted at submit)
        with trace_context(step=int(self.metrics.counters.get(
                "steps_total", 0))):
            # light + reused: the step span fires per scheduler round —
            # it records under a profiler capture window but skips the
            # flight ring (it would wrap the whole ring in <1s and its
            # HostSpan cost is THE per-step armed overhead; step timing
            # already lives in step_ms / StepTimer)
            with self._step_span:
                # expire BEFORE promoting: a deferred request whose
                # deadline lapsed while parked must shed as "deadline",
                # not first enter the queue (its no_shed exemption would
                # wrongfully push a viable fresh request over the cap)
                self._expire_deadlines()
                self._promote_backoff()
                self._admit()
                if self._by_engine_rid:
                    t0 = self._clock()
                    tokens_before = self.metrics.counters.get(
                        "tokens_generated_total", 0)
                    self.step_timer.begin()
                    ok = self._robust_step(params)
                    self.step_timer.end(
                        tokens=int(self.metrics.counters.get(
                            "tokens_generated_total", 0) - tokens_before))
                    self.metrics.observe("step_ms",
                                         (self._clock() - t0) * 1e3)
                    self.metrics.inc("steps_total")
                    if ok:
                        self.engine.collect()   # streams own the tokens
                self._sample_gauges()
                if self.slo_monitor is not None:
                    self.slo_monitor.tick()
                    if self.slo_monitor.breached():
                        # level-triggered remediation: the breach
                        # transition shed once, but refilling traffic
                        # must keep being trimmed while the latch holds
                        cap = int(self.config.max_queue_depth
                                  * (1 - self._slo_shed_fraction)) or 1
                        self._shed_overflow(cap=cap, reason="slo")
                if self.signal_bus is not None and history_armed[0]:
                    # sensor plane: decimated inside tick() — the common
                    # per-step cost is one clock read + compare
                    self.signal_bus.tick()

    def run(self, params, max_steps: Optional[int] = None) -> None:
        """Drive ``step`` until every request resolves (or degradation)."""
        steps = 0
        while self.pending and not self.degraded:
            self.step(params)
            steps += 1
            if self.pending and max_steps is not None \
                    and steps >= max_steps:
                raise RuntimeError(
                    f"serving loop exceeded max_steps={max_steps} with "
                    f"{self.pending} requests pending")
            if self.pending and self.active == 0:
                # only deferred backoff requests remain: nothing is
                # progressable until the clock passes the earliest ready
                # time — sleep straight to it instead of hot-spinning
                # (and exhausting max_steps on no-op rounds)
                wait = (min(r._ready_t for r in self._backoff)
                        - self._clock())
                if wait > 0:
                    self._sleep(wait)

    def _admit(self) -> None:
        """Feed the engine only requests it can place THIS step — a free
        slot AND enough free KV pages — in (priority, FIFO) order. The
        engine's internal FIFO must stay empty or priority inversions
        sneak in behind it: a request parked there (slot free but pages
        scarce) would be served before any later, higher-priority
        submission the moment pages return.

        Page math is unchanged by the unified ragged step, but the wave
        assumption is gone: an admission handed over here joins the
        engine's CURRENT step's ragged batch (prefill rides the same
        single dispatch as everyone's decode) instead of waiting for a
        bucketed prefill wave, so admission latency is one step, not one
        wave boundary."""
        if not self._queue:
            return              # steady decode: nothing to admit, and
        # the span/byte prelude below is armed-loop cost per step
        now = self._clock()
        armed = spans_armed()
        mgr = self.engine.mgr
        headroom = self.engine.num_free_slots - self.engine.num_queued
        free_pages = mgr.num_free_pages
        page_b = mgr.page_nbytes if armed else 0   # span-args byte unit
        cache = getattr(self.engine, "cache", None)
        protect: List[int] = []     # pages THIS step's admissions rely on
        while headroom > 0 and self._queue:
            req = self._queue[0]
            adm0_ns = time.perf_counter_ns() if armed else 0
            need = mgr.pages_for(
                len(req.prompt) + self._engine_budget(req.max_new_tokens))
            n_shared = 0
            reusing: List[int] = []
            if cache is not None:
                # charge only the UNCACHED SUFFIX: pages the prefix cache
                # will lend come for free (peek: no LRU/stat distortion);
                # the COW source isn't charged for but must survive too
                shareable, _cached_tokens, cow_src = cache.peek(req.prompt)
                n_shared = len(shareable)
                need -= n_shared
                reusing = shareable + ([cow_src] if cow_src is not None
                                       else [])
                if need > free_pages:
                    # reclaim cold cached pages before deferring — but
                    # never pages an admission already charged against
                    # this step (their refcounts rise only when the
                    # engine allocates), nor this request's own match
                    free_pages += cache.evict(need - free_pages,
                                              protect=protect + reusing)
            if need > free_pages:
                # deferred for pages: record the shortfall instead of
                # silently waiting — the rejects counter is the honest
                # pressure signal, the oom_pressure event
                # carries the bytes short (deduped per blocked request)
                memory_ledger.note_admission_reject(
                    mgr, request_id=req.rid, need_pages=need,
                    free_pages=free_pages, trace_id=req.trace_id)
                break               # wait for a completion to free pages
            protect.extend(reusing)
            self._queue.pop(0)
            self._order.pop(0)
            req.engine_rid = self.engine.submit(
                req.prompt, max_new_tokens=req.max_new_tokens,
                trace_id=req.trace_id, sampler=req.sampler,
                grammar=req.grammar, grammar_prefix=req.grammar_prefix)
            req.state = RequestState.RUNNING
            self._by_engine_rid[req.engine_rid] = req
            if journal_armed[0]:
                # the scheduler rid <-> engine rid binding: lets replay
                # correlate outcome frames with engine-side checksums
                journal.note_admit(srid=req.rid,
                                   engine_rid=req.engine_rid,
                                   ns=self.metrics.namespace)
            if armed:
                # two non-overlapping timeline segments, one batch:
                # queued until this admission pass picked the request
                # up, then the admission work itself (cache peek/evict,
                # allocation, engine handover). The admission span and
                # the request envelope both carry the HBM attribution
                # (total pages held, cached-vs-fresh bytes) so /tracez
                # shows a request's memory cost next to its latency.
                ns = self.metrics.namespace
                if req._span is not None and req._span.args is not None:
                    req._span.args.update(
                        kv_pages=need + n_shared,
                        cached_bytes=n_shared * page_b,
                        fresh_bytes=need * page_b)
                emit_spans([
                    make_span(f"{ns}.queue_wait", req._submit_ns,
                              adm0_ns, trace_id=req.trace_id,
                              args={"request_id": req.rid}),
                    make_span(f"{ns}.admission", adm0_ns,
                              time.perf_counter_ns(),
                              trace_id=req.trace_id,
                              args={"request_id": req.rid,
                                    "kv_pages": need + n_shared,
                                    "cached_bytes": n_shared * page_b,
                                    "fresh_bytes": need * page_b}),
                ])
            self.metrics.observe("queue_wait_ms",
                                 (now - req.submit_t) * 1e3,
                                 trace_id=req.trace_id)
            headroom -= 1
            free_pages -= need

    # -- robustness ---------------------------------------------------------

    def _robust_step(self, params) -> bool:
        """engine.step with timeout + bounded exponential backoff; on
        exhaustion degrade (drain everything with a structured error)
        instead of raising. True if the step eventually succeeded."""
        cfg = self.config
        delay = cfg.retry_backoff_s
        last_err: Optional[BaseException] = None
        for attempt in range(cfg.max_step_retries + 1):
            try:
                self._timed_step(params)
                return True
            except Exception as e:              # noqa: BLE001 - rethrown
                last_err = e
                self.metrics.inc("step_failures_total")
                if attempt < cfg.max_step_retries:
                    self.metrics.inc("step_retries_total")
                    self.metrics.mark("step_retry")
                    emit_event("step_retry", attempt=attempt + 1,
                               error=repr(e), backoff_s=delay)
                    self._sleep(delay)
                    delay *= cfg.retry_backoff_multiplier
        self._degrade(last_err)
        return False

    def _timed_step(self, params) -> None:
        timeout = self.config.step_timeout_s
        if timeout is None:
            self.engine.step(params)
            return
        if self._watchdog is not None:
            prev, prev_box = self._watchdog
            if prev.is_alive():
                # a timed-out attempt is still executing inside the
                # engine; NEVER start a second concurrent engine.step
                # (they would race on slots/pages/rng). Spend this
                # attempt's budget waiting for the straggler instead.
                prev.join(timeout)
            if prev.is_alive():
                raise ServingError(
                    "engine_failure",
                    f"engine.step still running past another "
                    f"step_timeout_s={timeout} window; refusing a "
                    "concurrent step")
            self._watchdog = None
            if "error" in prev_box:
                raise prev_box["error"]
            return          # straggler completed: that WAS the step
        box: Dict[str, Any] = {}
        # the worker steps on this thread's device and current stream
        scope = stream_scope(getattr(self.engine, "device", None))

        def worker():
            try:
                with scope():
                    box["result"] = self.engine.step(params)
            except BaseException as e:          # noqa: BLE001 - rethrown
                box["error"] = e

        t = threading.Thread(target=worker, daemon=True,
                             name="serving-step")
        t.start()
        t.join(timeout)
        if t.is_alive():
            self._watchdog = (t, box)
            flight_recorder.auto_dump("watchdog_timeout")
            raise ServingError(
                "engine_failure",
                f"engine.step exceeded step_timeout_s={timeout}")
        if "error" in box:
            raise box["error"]

    def _degrade(self, err: Optional[BaseException]) -> None:
        """Repeated step failure: drain every in-flight and queued request
        with a structured error; the loop survives, the scheduler refuses
        new work."""
        self.degraded = True
        self.metrics.set_gauge("degraded", 1.0)
        self.metrics.mark("degraded")
        emit_event("degraded", error=repr(err) if err else None,
                   inflight=len(self._by_engine_rid),
                   queued=len(self._queue))
        # postmortem while the torn state is still inspectable (no-op
        # unless the flight recorder is armed with a dump dir)
        flight_recorder.auto_dump("engine_step_failure")
        cause = f": {err}" if err is not None else ""
        for req in list(self._by_engine_rid.values()):
            try:
                self.engine.cancel(req.engine_rid)  # reclaim slot + pages
            except Exception:   # noqa: BLE001 - engine state may be torn
                pass
            self._finish(req, RequestState.FAILED, "failed",
                         ServingError("engine_failure",
                                      f"engine step failed repeatedly"
                                      f"{cause}", rid=req.rid))
        self._by_engine_rid.clear()
        for req in self._queue + self._backoff:
            self._finish(req, RequestState.FAILED, "failed",
                         ServingError("engine_failure",
                                      f"engine degraded before admission"
                                      f"{cause}", rid=req.rid))
        self._queue.clear()
        self._order.clear()
        self._backoff.clear()

    # -- engine hook targets ------------------------------------------------

    def _on_engine_token(self, engine_rid: int, token: int) -> None:
        req = self._by_engine_rid.get(engine_rid)
        if req is None:
            return
        now = self._clock()
        if req.first_token_t is None:
            req.first_token_t = now
            self.metrics.observe("ttft_ms", (now - req.submit_t) * 1e3,
                                 trace_id=req.trace_id)
        else:
            self.metrics.observe("itl_ms",
                                 (now - req.last_token_t) * 1e3,
                                 trace_id=req.trace_id)
        req.last_token_t = now
        self.metrics.inc("tokens_generated_total")
        req.stream.push(int(token))

    def _on_engine_finish(self, engine_rid: int, tokens: list) -> None:
        req = self._by_engine_rid.pop(engine_rid, None)
        if req is None:
            return
        req.token_checksum = self.engine.finished_checksum(engine_rid)
        self._finish(req, RequestState.DONE, "complete")
        self.metrics.inc("requests_completed_total")
        self.metrics.observe("e2e_ms",
                             (req.finish_t - req.submit_t) * 1e3,
                             trace_id=req.trace_id)

    # -- accounting ---------------------------------------------------------

    def _sample_gauges(self) -> None:
        m = self.metrics
        depth = len(self._queue)
        m.set_gauge("queue_depth", depth)
        m.observe("queue_depth", depth)
        m.set_gauge("inflight", len(self._by_engine_rid))
        slots = self.engine.num_slots
        m.set_gauge("slot_utilization",
                    (slots - self.engine.num_free_slots) / slots)
        # ONE occupancy derivation (observability.memory.pool_occupancy):
        # these gauges, the signal bus's pool-pressure reader and the
        # ledger's byte split all read the same math, so /metrics and
        # the autoscaler can never disagree about what "full" means
        occ = pool_occupancy(self.engine.mgr)
        m.set_gauge("page_utilization", occ["pressure"])
        cache = getattr(self.engine, "cache", None)
        if cache is not None:
            # cached-vs-live split: how much of the occupied pool is
            # reusable cache vs pinned by in-flight sequences
            m.set_gauge("live_page_utilization", occ["live_utilization"])
            m.set_gauge("cached_page_utilization",
                        occ["cached_utilization"])
            cache.update_gauges()

    def statusz(self) -> Dict[str, Any]:
        """Live scheduler state for the diagnostics server's /statusz:
        queue composition, engine slot/page occupancy, lifecycle
        counters, step timing."""
        per_priority: Dict[int, int] = {}
        for req in self._queue:
            per_priority[req.priority] = per_priority.get(req.priority,
                                                          0) + 1
        mgr = self.engine.mgr
        out: Dict[str, Any] = {
            "queued": len(self._queue),
            "queued_by_priority": {str(k): v for k, v in
                                   sorted(per_priority.items())},
            "backoff": len(self._backoff),
            "inflight": len(self._by_engine_rid),
            "degraded": self.degraded,
            "slots": {"total": self.engine.num_slots,
                      "free": self.engine.num_free_slots},
            "pages": {"usable": mgr.usable_pages,
                      "free": mgr.num_free_pages},
            "counters": dict(self.metrics.counters),
            "shed": dict(self.metrics.shed),
            "step_ms": self.step_timer.step_ms.summary(),
            "tokens_per_s": self.step_timer.tokens_per_s,
        }
        cache = getattr(self.engine, "cache", None)
        if cache is not None:
            out["pages"]["live"] = mgr.num_live_pages
            out["pages"]["cached"] = mgr.num_cached_pages
            out["prefix_cache"] = cache.snapshot()
        spec = getattr(self.engine, "spec", None)
        if spec is not None:
            # speculation health (drafted/accepted/acceptance ratio):
            # /statusz and the router's fleet view surface it per engine
            out["speculation"] = spec.snapshot()
        ex = self.metrics.exemplars_snapshot()
        if ex:
            # the worst recent TTFT/ITL/e2e observation, each carrying
            # the trace id to pull from /tracez — histogram families
            # alone can't answer "WHICH request was the p99"
            out["exemplars"] = ex
        if timeline_armed[0]:
            # slowest-requests table (trace id, e2e, exclusive
            # critical-path segments) from the span collector; the full
            # trees live on /tracez
            out["slowest_requests"] = span_collector.slowest()
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.states()
        if self.signal_bus is not None:
            # smoothed signal values + windowed trends (the full series
            # and anomaly document lives on /varz)
            out["signals"] = self.signal_bus.values()
        if memory_armed[0]:
            # HBM ledger summary (class bytes + planner verdicts); the
            # per-request page table lives on /memz
            out["memory"] = memory_ledger.statusz()
        return out
