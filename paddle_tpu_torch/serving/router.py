"""Prefix-aware fleet router: N engine replicas behind one front door —
counterpart of ``paddle_tpu/serving/router.py``.

One ``ContinuousBatchingEngine`` is a single point of failure — a stuck
step or a dead host is a total outage. The :class:`FleetRouter` fronts N
:class:`~.replica.ReplicaHandle` replicas and owns the three concerns a
fleet adds on top of per-replica scheduling:

**Routing.** A router-side radix index (one
:class:`~paddle_tpu_torch.kvcache.radix.RadixTree` per replica, token blocks at
the engine's page size) records which replica served which prompt
prefix. A new request routes to the replica with the longest indexed
prefix overlap — the replica whose prefix cache most likely still holds
those KV pages — but only while that replica's load (``statusz()`` queue
depth + backoff + in-flight, plus a penalty while its SLO monitor is
burning) stays within ``load_band`` of the least-loaded candidate;
outside the band, load wins and the request spills to the least-loaded
replica. The index is a host-side *hint* (capped, LRU-evicted): a stale
entry costs a cache miss, never a wrong answer.

**Failure detection + re-admission.** Each replica's
:class:`~.health.HealthTracker` turns consecutive step failures and
watchdog silence into HEALTHY → SUSPECT → EJECTED transitions; ejection
fails over every live request, auto-dumps a flight-recorder bundle, and
stops all traffic. After a cooldown the breaker half-opens and the
router admits **exactly one** probe request; the probe completing
re-admits the replica (``replica_recovered``), a probe failure re-ejects
it with the cooldown doubled — so a flapping replica converges to
quarantine instead of flapping the fleet.

**Drain + mid-stream failover.** :meth:`drain` stops admissions, hands
the replica's still-queued requests to siblings, and lets in-flight
streams finish. When a replica dies mid-decode, each of its live
requests is resubmitted to a healthy sibling through the scheduler's
retry/backoff path (``submit(defer_s=...)``, exponential per-request
backoff): the resubmission's prompt is the original prompt plus every
token already streamed, with the remaining token budget — greedy decode
is prefix-deterministic, so the continuation is byte-identical to an
uninterrupted run and the consumer's stream just keeps going. Requests
that exhaust ``max_failovers`` fail terminally with a structured
:class:`~.stream.ServingError`; consumers never hang (router streams
also carry a producer-liveness guard for fatal, non-Exception deaths).

**Chaos.** ``fault_injector`` accepts a
:class:`~paddle_tpu_torch.resilience.faults.FaultInjector`; each router step
asks it per replica for ``replica_die`` / ``replica_stall`` /
``replica_slow`` events (one-shot, replica-scoped), mapped onto the
replica chaos surface. With a fake clock, a chaos run is deterministic
and its greedy outputs byte-identical to the fault-free run. On the card
the continuation *prefills* the streamed tokens that the uninterrupted
run decoded; at bf16 the prefill's attention tiles and GEMM row counts
round differently from the decode's, so there the identity holds for
fp32 and is measured, not promised, for bf16.

Telemetry: ``paddle_router_requests_total{replica,outcome}``,
``paddle_router_replica_state{replica}`` (0 healthy / 1 suspect /
2 ejected / 3 half-open / 4 draining / 5 drained),
``paddle_router_failovers_total``,
``paddle_router_prefix_affinity_hits_total``; JSONL events
``replica_ejected`` / ``replica_recovered`` / ``failover``;
:meth:`statusz` is the fleet view the diagnostics server mounts
(``DiagServer.attach_router``), and :meth:`make_slo_monitor` builds the
fleet-completion SLO (failover/drain remediation excluded from its own
objective, mirroring the scheduler's "slo"-shed exclusion).
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from ..kvcache.policy import LRUEvictionPolicy
from ..kvcache.radix import RadixTree
from ..observability.events import emit_event
from ..observability.flight import flight_recorder
from ..observability.journal import journal, journal_armed, token_checksum
from ..observability.registry import get_registry
from ..observability.timeseries import history_armed
from ..observability.trace import new_trace_id
from ..profiler.record import emit_span, spans_armed
from .health import STATE_CODE, ReplicaState
from .replica import ReplicaHandle
from .scheduler import RequestState
from .stream import ServingError, TokenStream


@dataclass
class RouterConfig:
    """Routing and failover knobs.

    ``load_band``: prefix affinity may only beat load while the
    preferred replica is within this many requests of the least-loaded
    candidate. ``burn_penalty``: effective-load surcharge while a
    replica's SLO monitor reports degraded/breached. Failover
    resubmissions back off ``failover_backoff_s *
    failover_backoff_multiplier**(n-1)`` and give up (terminal error)
    after ``max_failovers`` per request. ``index_max_nodes`` caps each
    replica's router-side radix index (LRU leaves evicted beyond it).
    ``stall_s``/``slow_s``/``slow_delay_s`` parameterize the injected
    ``replica_stall``/``replica_slow`` chaos events.
    """

    load_band: int = 4
    burn_penalty: float = 8.0
    failover_backoff_s: float = 0.05
    failover_backoff_multiplier: float = 2.0
    max_failovers: int = 3
    index_max_nodes: int = 4096
    stall_s: float = 0.3
    slow_s: float = 0.3
    slow_delay_s: float = 0.05


@dataclass
class RouterRequest:
    """Consumer-facing handle for one fleet request. ``stream`` is the
    consumption surface; it survives failovers (the per-replica streams
    underneath are internal plumbing)."""

    rid: int
    prompt: np.ndarray
    priority: int
    budget: int                        # total new-token budget
    stream: TokenStream = None
    submit_t: float = 0.0
    deadline_t: Optional[float] = None
    state: str = RequestState.QUEUED
    trace_id: str = ""                 # ONE id for the whole fleet path:
    # minted here at router submit, handed to every replica dispatch
    # (failover resubmissions included) so the request assembles into a
    # single span tree across replicas
    sampler: Any = None                # SamplerConfig with seed MATERIAL-
    # IZED at router submit: a failover resubmission must replay the same
    # per-request stream, so the seed cannot be re-derived from the
    # sibling engine's row ids
    grammar: Any = None                # TokenDFA constraint; the dispatch
    # passes the streamed tokens as grammar_prefix so the sibling's DFA
    # resumes mid-string
    _submit_ns: int = field(default=0, repr=False)
    _failover_ns: int = field(default=0, repr=False)  # ejection time of a
    # pending failover; the next dispatch emits the router.failover_gap
    # span from it (the attributed "replica died -> sibling took over"
    # segment) and clears it
    replica_id: Optional[int] = None   # current assignment
    handle: Any = field(default=None, repr=False)  # replica-level request
    failovers: int = 0
    routed_by_affinity: bool = False   # initial routing won on prefix
    pending_failover_from: Optional[int] = field(default=None, repr=False)
    # ^ failover parked with no routable sibling: the resubmission
    # counter fires when a healed replica finally takes the request
    redispatched: bool = field(default=False, repr=False)  # any dispatch
    # after the first is remediation (failover / drain handoff) and is
    # exempt from the sibling scheduler's queue-cap shedding
    _parked_t: float = field(default=0.0, repr=False)  # when the request
    # last parked (no routable replica); the parked-age histogram and
    # the parked_expired shed event observe the wait from it
    first_token_t: Optional[float] = None
    failover_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED,
                              RequestState.SHED, RequestState.FAILED)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.submit_t) * 1e3


class FleetRouter:
    """See module docstring."""

    def __init__(self, replicas: Sequence[ReplicaHandle],
                 config: Optional[RouterConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 fault_injector=None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: Dict[int, ReplicaHandle] = {}
        for r in replicas:
            if r.replica_id in self.replicas:
                raise ValueError(f"duplicate replica id {r.replica_id}")
            self.replicas[r.replica_id] = r
        self.config = config or RouterConfig()
        self._clock = clock
        self._sleep = sleep
        self.injector = fault_injector
        self._next_rid = 0
        self._steps = 0
        # streams' producer-liveness cell: a one-field box (not `self`)
        # so consumer-held streams never pin the whole router — engines,
        # page pools, index — in memory after a fleet teardown
        self._alive = [True]
        self._requests: Dict[int, RouterRequest] = {}   # unresolved only
        self._parked: List[RouterRequest] = []  # no routable replica yet
        self._probe: Dict[int, int] = {}        # replica id -> router rid
        # last health state journaled per replica: the end-of-step diff
        # that turns breaker walks into journal `health` frames
        self._journal_health: Dict[int, str] = {}
        self.slo_monitor = None
        self.signal_bus = None                  # see attach_signal_bus
        # router-side prefix index: one tree per replica, synthetic page
        # ids (the tree wants unique ints; pages here are just node keys)
        self._index: Dict[int, RadixTree] = {
            rid: RadixTree(r.engine.page_size)
            for rid, r in self.replicas.items()}
        self._index_lru = LRUEvictionPolicy()
        self._next_index_page = 0
        # cumulative outcomes (the fleet SLO samples these, and local
        # mirrors keep tests independent of registry resets)
        self.accepted_total = 0
        self.failed_total = 0              # terminal failures only
        self.shed_total = 0
        reg = get_registry()
        self._c_requests = reg.counter(
            "paddle_router_requests_total",
            "terminal request outcomes and failover handoffs per replica",
            labels=("replica", "outcome"))
        self._g_state = reg.gauge(
            "paddle_router_replica_state",
            "replica breaker state: 0 healthy / 1 suspect / 2 ejected / "
            "3 half-open / 4 draining / 5 drained",
            labels=("replica",))
        self._c_failovers = reg.counter(
            "paddle_router_failovers_total",
            "mid-stream failovers (dead replica -> sibling resubmission)")
        self._c_affinity = reg.counter(
            "paddle_router_prefix_affinity_hits_total",
            "requests routed to the replica with the longest cached "
            "prefix overlap")
        self._h_parked_age = reg.histogram(
            "paddle_router_parked_age_seconds",
            "time a request waited parked (no routable replica) before "
            "a dispatch or its deadline shed — the all-down backlog "
            "age the autoscaler's scale-up watches")
        # ejection bundles must be self-contained: the flight recorder
        # embeds this fleet's /statusz view (fleet.json) and the active
        # request timelines (timelines.json) in every debug bundle
        flight_recorder.attach_router(self)

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, priority: int = 0,
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               sampler: Any = None,
               grammar: Any = None) -> RouterRequest:
        """Route a request into the fleet. Same contract as
        ``ServingScheduler.submit`` (priority classes, deadline,
        per-request budget, synchronous ``on_token``), plus fleet
        semantics: with no routable replica the request parks and is
        retried each router step until a replica heals or its deadline
        lapses. The returned handle's ``.stream`` survives failovers —
        including sampled ones: an unseeded ``sampler`` gets its seed
        materialized HERE (not per replica), so a failover resubmission
        replays the identical stream on the sibling; a ``grammar``
        constraint likewise survives because each dispatch pre-advances
        the DFA through the already-streamed tokens."""
        prompt = np.asarray(prompt, np.int32)
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        any_replica = next(iter(self.replicas.values()))
        budget = (int(max_new_tokens) if max_new_tokens is not None
                  else any_replica.default_max_new_tokens)
        # infeasibility is a CALLER error, judged here against the fleet
        # (assumed homogeneous) so it can never be mistaken for replica
        # failures and poison the breakers
        eng = any_replica.engine
        total = len(prompt) + budget
        if total > eng.max_seq_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens + max_new_tokens="
                f"{budget} exceeds the replicas' max_seq_len="
                f"{eng.max_seq_len}")
        if eng.mgr.pages_for(total) > eng.mgr.usable_pages:
            raise ValueError(
                f"request of {total} total tokens needs "
                f"{eng.mgr.pages_for(total)} KV pages but each replica "
                f"pool only holds {eng.mgr.usable_pages}")
        if sampler is not None:
            # pin the seed at the fleet boundary: replica row ids differ
            # across siblings, so any seed derived below this layer
            # would break failover replay
            sampler = sampler.resolved(rid * 1000003 + 7919)
        req = RouterRequest(
            rid=rid, prompt=prompt, priority=int(priority), budget=budget,
            stream=TokenStream(rid, on_token=on_token), submit_t=now,
            deadline_t=None if deadline_ms is None
            else now + deadline_ms / 1e3,
            trace_id=new_trace_id("req"),
            sampler=sampler, grammar=grammar)
        req._submit_ns = time.perf_counter_ns()
        if journal_armed[0]:
            # the arrival frame carries EVERYTHING replay needs to
            # re-submit this request: tokens, budget, priority/deadline,
            # the seed resolved above, the grammar fingerprint
            journal.note_arrival(
                rid=rid, clock=now, prompt=[int(t) for t in prompt],
                prompt_crc=token_checksum(prompt),
                priority=int(priority), deadline_ms=deadline_ms,
                budget=budget,
                sampler=(None if sampler is None else {
                    "temperature": sampler.temperature,
                    "top_k": sampler.top_k, "top_p": sampler.top_p,
                    "seed": sampler.seed}),
                grammar=(None if grammar is None else {
                    "pattern": getattr(grammar, "pattern", None),
                    "fingerprint": getattr(grammar, "fingerprint", None),
                    "eos_token_id": getattr(grammar, "eos_token_id",
                                            None)}))
        # a fatal (non-Exception) router death closes consumer streams
        # via the producer-liveness poll instead of leaving them blocked
        alive = self._alive
        req.stream.attach_producer(lambda: alive[0])
        self._requests[rid] = req
        self.accepted_total += 1
        self._route(req)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a routed or parked request; False if unknown/finished."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        if req.handle is not None:
            r = self.replicas.get(req.replica_id)
            if r is not None:
                try:
                    r.cancel(req.handle.rid)
                except Exception:   # a dead replica cannot veto a cancel
                    pass
        else:
            if req in self._parked:
                self._parked.remove(req)
        self._finish(req, RequestState.CANCELLED, "cancelled", None,
                     outcome="cancelled")
        return True

    # -- routing policy -----------------------------------------------------

    def _overlap_tokens(self, replica_id: int, prompt) -> int:
        tree = self._index[replica_id]
        # peek-style match: scoring every candidate must not distort LRU
        return len(tree.match(prompt, touch=False)) * tree.page_size

    def _load(self, r: ReplicaHandle) -> float:
        load = float(r.queue_depth + r.inflight)
        mon = r.slo_monitor
        if mon is not None and mon.health() != "ok":
            load += self.config.burn_penalty
        return load

    def _pick(self, prompt, exclude: Set[int]):
        """Choose a replica: ``(replica_id, affinity_hit, is_probe)`` or
        ``(None, False, False)`` when nothing is routable. Half-open
        replicas take exactly one request (the probe) before anything
        else is considered; EJECTED and draining replicas never
        receive traffic."""
        for rid in sorted(self.replicas):
            r = self.replicas[rid]
            if rid in exclude or r.draining or r.degraded:
                continue
            if (r.health.state == ReplicaState.HALF_OPEN
                    and rid not in self._probe):
                return rid, False, True
        candidates = [
            rid for rid in sorted(self.replicas)
            if rid not in exclude
            and not self.replicas[rid].draining
            and not self.replicas[rid].degraded
            and self.replicas[rid].health.accepting]
        if not candidates:
            return None, False, False
        loads = {rid: self._load(self.replicas[rid])
                 for rid in candidates}
        min_load = min(loads.values())
        best_rid, best_ov = None, 0
        for rid in candidates:
            ov = self._overlap_tokens(rid, prompt)
            if ov > best_ov or (ov == best_ov and best_rid is not None
                                and ov > 0
                                and loads[rid] < loads[best_rid]):
                best_rid, best_ov = rid, ov
        if (best_ov > 0
                and loads[best_rid] - min_load <= self.config.load_band):
            return best_rid, True, False
        # load wins: least-loaded candidate, lowest id as the
        # deterministic tie-break
        rid = min(candidates, key=lambda c: (loads[c], c))
        return rid, False, False

    def _route(self, req: RouterRequest, exclude: Set[int] = frozenset(),
               defer_s: Optional[float] = None) -> None:
        exclude = set(exclude)
        while True:
            rid, affinity, probe = self._pick(req.prompt, exclude)
            if rid is None:
                req.handle = None
                req.replica_id = None
                if req not in self._parked:
                    req._parked_t = self._clock()
                    self._parked.append(req)
                return
            try:
                self._dispatch(req, rid, defer_s)
            except ServingError as e:
                # a replica refusing submissions (degraded under us) is
                # failing: record it and try the next candidate —
                # infeasible-request ValueErrors are caller errors and
                # propagate from submit() instead of landing here
                r = self.replicas[rid]
                r.health.record_failure(f"submit failed: {e!r}")
                if r.health.state == ReplicaState.EJECTED:
                    self._eject(rid, r, f"submit failed: {e!r}")
                exclude.add(rid)
                continue
            if probe:
                self._probe[rid] = req.rid
            if affinity:
                self._c_affinity.inc()
                if req.failovers == 0:
                    req.routed_by_affinity = True
            return

    def _dispatch(self, req: RouterRequest, rid: int,
                  defer_s: Optional[float]) -> None:
        r = self.replicas[rid]
        streamed = req.stream.tokens
        # failover continuation: prompt grows by the already-streamed
        # tokens, budget shrinks by the same count — decode then resumes
        # byte-identically on the sibling (greedy trivially; sampled
        # because the epilogue keys its PRNG by absolute token position
        # from a seed pinned at router submit). ``decoded`` tells the
        # engine which prompt tokens were decoded: it prefills them on
        # the attention route they were decoded on, so the bits hold at
        # bf16 too
        prompt = (req.prompt if not streamed else
                  np.concatenate([req.prompt,
                                  np.asarray(streamed, np.int32)]))
        budget = req.budget - len(streamed)
        now = self._clock()
        remaining_ms = (None if req.deadline_t is None
                        else max((req.deadline_t - now) * 1e3, 0.0))

        def _on_token(tok: int, req=req) -> None:
            if req.first_token_t is None:
                req.first_token_t = self._clock()
            req.stream.push(tok)

        req.handle = r.submit(prompt, priority=req.priority,
                              deadline_ms=remaining_ms,
                              max_new_tokens=budget, on_token=_on_token,
                              defer_s=defer_s,
                              no_shed=req.redispatched,
                              trace_id=req.trace_id,
                              sampler=req.sampler, grammar=req.grammar,
                              grammar_prefix=(list(streamed)
                                              if req.grammar is not None
                                              and streamed else None),
                              decoded=len(streamed))
        if req._failover_ns:
            if spans_armed():
                # the attributed failover segment: replica ejected ->
                # a sibling accepted the resubmission
                emit_span("router.failover_gap", req._failover_ns,
                          time.perf_counter_ns(), trace_id=req.trace_id,
                          args={"request_id": req.rid, "to_replica": rid,
                                "attempt": req.failovers})
            req._failover_ns = 0
        req.redispatched = True
        req.replica_id = rid
        if req in self._parked:
            self._parked.remove(req)
            self._h_parked_age.observe(max(now - req._parked_t, 0.0))
        # index optimistically at dispatch so a burst of same-prefix
        # requests coalesces onto one replica from the first routing
        self._index_insert(rid, [int(t) for t in prompt])

    def _index_insert(self, rid: int, tokens: List[int]) -> None:
        tree = self._index[rid]
        n_blocks = len(tokens) // tree.page_size
        if n_blocks == 0:
            return
        pages = list(range(self._next_index_page,
                           self._next_index_page + n_blocks))
        self._next_index_page += n_blocks
        tree.insert(tokens, pages)
        overflow = len(tree) - self.config.index_max_nodes
        if overflow > 0:
            # the kvcache LRU policy (one leaf scan + heap, children
            # before parents) over synthetic pages: nothing is pinned,
            # so every node is refcount-0 evictable
            for victim in self._index_lru.select(tree, lambda _p: 0,
                                                 overflow):
                tree.remove(victim)

    # -- the fleet loop -----------------------------------------------------

    @property
    def pending(self) -> int:
        """Unresolved router requests (routed + parked)."""
        return len(self._requests)

    @property
    def parked(self) -> int:
        """Requests waiting for ANY routable replica (fleet backlog the
        sensor plane watches: a growing parked count is the clearest
        "scale up" signal there is)."""
        return len(self._parked)

    def step(self, params) -> int:
        """One fleet round: inject scheduled chaos, advance breakers,
        retry parked requests, step every live replica (failures feed
        the breakers; ejections fail over), resolve finished requests,
        refresh gauges, tick the fleet SLO. Returns ``pending``."""
        try:
            self._step_inner(params)
        except BaseException as e:
            if not isinstance(e, Exception):
                # fatal death: let every consumer stream observe it
                # through the producer-liveness guard, then re-raise
                self._alive[0] = False
            raise
        return self.pending

    def _step_inner(self, params) -> None:
        cfg = self.config
        self._steps += 1
        if journal_armed[0]:
            # the injected-clock sample is the replay anchor: pinning a
            # settable clock to it makes deadlines, backoffs and breaker
            # cooldowns land on the same step they did in production
            journal.note_step(self._steps, self._clock())
        # 1. scheduled chaos, replica-scoped and one-shot
        if self.injector is not None:
            for rid, r in self.replicas.items():
                if self.injector.fire("replica_die", self._steps,
                                      replica=rid):
                    r.kill()
                if self.injector.fire("replica_stall", self._steps,
                                      replica=rid):
                    r.stall(cfg.stall_s)
                if self.injector.fire("replica_slow", self._steps,
                                      replica=rid):
                    r.slow(cfg.slow_s, cfg.slow_delay_s)
        # 2. cooldowns: EJECTED -> HALF_OPEN
        for r in self.replicas.values():
            r.health.tick()
        # 3. parked requests: a replica may have healed or half-opened —
        # but a deadline that lapsed while parked sheds FIRST (re-routing
        # it would clamp the remaining deadline to 0 and, under a fake
        # clock, serve a request the contract says is dead)
        if self._parked:
            now = self._clock()
            for req in list(self._parked):
                if req.done:
                    continue
                if req.deadline_t is not None and now > req.deadline_t:
                    self._shed_parked(req)
                    continue
                self._route(req)
                if (req.handle is not None
                        and req.pending_failover_from is not None):
                    # the parked failover finally resubmitted somewhere
                    self._count_failover(req.pending_failover_from)
                    req.pending_failover_from = None
        # 4. step the fleet
        for rid in sorted(self.replicas):
            r = self.replicas[rid]
            state = r.health.state
            if state == ReplicaState.EJECTED:
                continue
            if (state == ReplicaState.HALF_OPEN
                    and self._probe.get(rid) is None):
                continue            # idle half-open: wait for a probe
            busy = r.active > 0
            if r.health.check_watchdog(busy=busy):
                if r.health.state == ReplicaState.EJECTED:
                    self._eject(rid, r, "watchdog timeout")
                    continue
            prev = r.health.state
            mark = r.progress_marker if busy else None
            try:
                r.step(params)
            except Exception as e:
                r.health.record_failure(repr(e))
                if r.health.state == ReplicaState.EJECTED:
                    self._eject(rid, r, repr(e))
                continue
            if r.degraded:
                # the scheduler burned its retry budget and drained
                # itself: unrecoverable without a fresh engine
                r.health.force_eject("scheduler degraded")
                self._eject(rid, r, "scheduler degraded")
                continue
            if busy and r.progress_marker == mark:
                # the step returned but served NOTHING: don't refresh
                # the watchdog window — a wedged-but-returning replica
                # must still trip it (no failure recorded either; the
                # watchdog is the judge of sustained silence)
                continue
            r.health.record_success()
            if (prev == ReplicaState.SUSPECT
                    and r.health.state == ReplicaState.HEALTHY):
                emit_event("replica_recovered", replica=rid, via="healed")
        # 5. resolve finished requests / expire parked deadlines
        self._scan_requests()
        # 6. drained latches + state gauge + fleet SLO
        if journal_armed[0]:
            # end-of-step health diff: one frame per TRANSITION, never
            # per step, so a stable fleet journals nothing here
            for rid in sorted(self.replicas):
                state = self.replicas[rid].health.state
                prev = self._journal_health.get(rid)
                if state != prev:
                    self._journal_health[rid] = state
                    journal.note_health(replica=rid, prev=prev,
                                        state=state)
        for rid, r in self.replicas.items():
            if (r.draining and not r.drained_event_sent
                    and not any(q.replica_id == rid and q.handle is not None
                                for q in self._requests.values())):
                r.drained_event_sent = True
                emit_event("replica_drained", replica=rid)
            self._g_state.set(self._state_code(r), replica=str(rid))
        if self.slo_monitor is not None:
            self.slo_monitor.tick()
        if self.signal_bus is not None and history_armed[0]:
            # sensor plane: decimated inside tick() — the common
            # per-step cost is one clock read + compare
            self.signal_bus.tick()

    def run(self, params, max_steps: Optional[int] = None) -> None:
        """Drive ``step`` until every request resolves."""
        steps = 0
        while self.pending:
            before = self.pending
            self.step(params)
            steps += 1
            if self.pending and max_steps is not None \
                    and steps >= max_steps:
                raise RuntimeError(
                    f"fleet loop exceeded max_steps={max_steps} with "
                    f"{self.pending} requests pending")
            self._backoff_if_stalled(before)

    def _backoff_if_stalled(self, pending_before: int) -> None:
        """Nothing progressable this instant (backoff timers / breaker
        cooldowns pending): let the clock advance. Shared by :meth:`run`
        and the elastic controller's fleet loop so the stall heuristic
        can never drift between the two."""
        if (self.pending == pending_before and self.pending
                and not any(r.active for r in self.replicas.values())):
            self._sleep(self.config.failover_backoff_s / 4)

    # -- failure handling ---------------------------------------------------

    def _eject(self, rid: int, r: ReplicaHandle, reason: str) -> None:
        inflight = [req for req in self._requests.values()
                    if req.replica_id == rid and req.handle is not None
                    and not req.done]
        emit_event("replica_ejected", replica=rid, error=reason,
                   inflight=len(inflight),
                   trace_ids=sorted(req.trace_id for req in inflight),
                   consecutive_failures=r.health.consecutive_failures,
                   cooldown_s=r.health.cooldown_s)
        # postmortem while the replica's torn state is inspectable
        # (no-op unless the flight recorder is armed with a dump dir)
        flight_recorder.auto_dump(f"replica_ejected_{rid}")
        self._probe.pop(rid, None)
        for req in inflight:
            h = req.handle
            if h.state in (RequestState.DONE, RequestState.SHED):
                continue            # terminal at the replica: scan closes it
            try:
                r.cancel(h.rid)     # reclaim slot/pages when still possible
            except Exception:
                pass
            self._failover(req, rid, reason)

    def _failover(self, req: RouterRequest, from_rid: int,
                  reason: str) -> None:
        cfg = self.config
        req.failovers += 1
        req.failover_t = self._clock()
        if not req._failover_ns:        # a parked retry keeps the FIRST
            req._failover_ns = time.perf_counter_ns()   # ejection time
        toks = req.stream.tokens
        streamed = len(toks)
        eos = next(iter(self.replicas.values())).engine.config.eos_token_id
        if streamed >= req.budget or (eos is not None and toks
                                      and toks[-1] == eos):
            # everything was already delivered (budget spent, or the
            # stream already ended on EOS — resubmitting would decode
            # PAST it, since the streamed EOS becomes prompt on the
            # sibling); only the close was lost. Salvage BEFORE the
            # exhaustion check, or a last-permitted failover would FAIL
            # a request the consumer fully holds.
            self._finish(req, RequestState.DONE, "complete", None,
                         outcome="completed")
            return
        if req.failovers > cfg.max_failovers:
            self._finish(req, RequestState.FAILED, "failed",
                         ServingError(
                             "failover_exhausted",
                             f"request {req.rid} failed over "
                             f"{req.failovers} times (last replica "
                             f"{from_rid}: {reason})", rid=req.rid),
                         outcome="failed")
            emit_event("failover", request_id=req.rid,
                       trace_id=req.trace_id,
                       from_replica=from_rid, to_replica=None,
                       streamed=streamed, attempt=req.failovers,
                       exhausted=True)
            return
        defer = (cfg.failover_backoff_s
                 * cfg.failover_backoff_multiplier ** (req.failovers - 1))
        self._route(req, exclude={from_rid}, defer_s=defer)
        # the metric means "sibling resubmissions", not "times a replica
        # lost a request": counted only when the dispatch actually
        # happened — a parked request counts later, when a healed
        # replica finally takes it (see the parked retry in step 3)
        if req.handle is not None:
            self._count_failover(from_rid)
            emit_event("failover", request_id=req.rid,
                       trace_id=req.trace_id,
                       from_replica=from_rid, to_replica=req.replica_id,
                       streamed=streamed, attempt=req.failovers,
                       backoff_s=round(defer, 4))
        else:
            req.pending_failover_from = from_rid
            emit_event("failover", request_id=req.rid,
                       trace_id=req.trace_id,
                       from_replica=from_rid, to_replica=None,
                       streamed=streamed, attempt=req.failovers,
                       parked=True)

    def _count_failover(self, from_rid: int) -> None:
        self._c_failovers.inc()
        self._c_requests.inc(replica=str(from_rid), outcome="failover")

    def _scan_requests(self) -> None:
        now = self._clock()
        for req in list(self._requests.values()):
            if req.done:
                self._requests.pop(req.rid, None)
                continue
            h = req.handle
            if h is None:           # parked: only its deadline moves it
                if req.deadline_t is not None and now > req.deadline_t:
                    self._shed_parked(req)
                continue
            if not h.done:
                continue
            if h.state == RequestState.DONE:
                self._index_insert(
                    req.replica_id,
                    [int(t) for t in req.prompt] + req.stream.tokens)
                self._finish(req, RequestState.DONE, "complete", None,
                             outcome="completed")
            elif h.state == RequestState.SHED:
                self._finish(req, RequestState.SHED,
                             h.stream.finish_reason, h.stream.error,
                             outcome="shed")
            else:
                # FAILED (scheduler degraded under us) or an unexpected
                # replica-side cancel: both mean the replica lost the
                # request — fail it over
                self._failover(req, req.replica_id,
                               f"replica-side {h.state}")

    def _shed_parked(self, req: RouterRequest) -> None:
        age = max(self._clock() - req._parked_t, 0.0)
        if req in self._parked:
            self._parked.remove(req)
            self._h_parked_age.observe(age)
        emit_event("parked_expired", request_id=req.rid,
                   trace_id=req.trace_id, age_s=round(age, 6),
                   deadline_t=req.deadline_t)
        self._finish(req, RequestState.SHED, "shed:deadline",
                     ServingError("shed_deadline",
                                  f"request {req.rid} unroutable past "
                                  "its deadline", rid=req.rid),
                     outcome="shed")

    def _finish(self, req: RouterRequest, state: str, reason: str,
                error: Optional[ServingError], outcome: str) -> None:
        req.state = state
        req.finish_t = self._clock()
        if journal_armed[0]:
            # terminal frame: the stream checksum is what replay diffs
            # to prove byte-identical reproduction; the engine-side crc
            # cross-checks that the stream matched what decode retired
            toks = [int(t) for t in req.stream.tokens]
            journal.note_outcome(
                rid=req.rid, state=state, outcome=outcome,
                replica=req.replica_id, failovers=req.failovers,
                tokens=toks, stream_crc=token_checksum(toks),
                engine_crc=(getattr(req.handle, "token_checksum", None)
                            if req.handle is not None else None))
        if req._submit_ns and spans_armed():
            # the fleet-level request envelope: the timeline collector's
            # root span, spanning router submit -> terminal outcome
            # across every replica attempt
            emit_span("router.request", req._submit_ns,
                      time.perf_counter_ns(), trace_id=req.trace_id,
                      args={"request_id": req.rid, "outcome": outcome,
                            "failovers": req.failovers})
        req.stream.close(reason, error)
        self._c_requests.inc(
            replica=(str(req.replica_id) if req.replica_id is not None
                     else "none"),
            outcome=outcome)
        if outcome == "failed":
            self.failed_total += 1
        elif outcome == "shed":
            self.shed_total += 1
        rid = req.replica_id
        if rid is not None and self._probe.get(rid) == req.rid:
            # the half-open probe resolved: completion closes the
            # circuit; anything else leaves the replica half-open for
            # the next probe (its own step failures re-eject it)
            del self._probe[rid]
            if outcome == "completed":
                self.replicas[rid].health.record_probe_success()
                emit_event("replica_recovered", replica=rid, via="probe")
        self._requests.pop(req.rid, None)

    # -- drain / fleet management -------------------------------------------

    def drain(self, replica_id: int) -> None:
        """Gracefully remove a replica from rotation: no new admissions,
        queued (not yet decoding) requests hand off to siblings now,
        in-flight streams finish where they are."""
        r = self.replicas[replica_id]
        if r.draining:
            return
        r.draining = True
        r.drained_event_sent = False
        # a queued half-open probe hands off with everything else below;
        # drop its bookkeeping or the stale entry would block any future
        # probe (and the replica would sit HALF_OPEN forever)
        self._probe.pop(replica_id, None)
        emit_event("replica_draining", replica=replica_id,
                   inflight=r.inflight, queued=r.queue_depth)
        for req in list(self._requests.values()):
            if (req.replica_id != replica_id or req.handle is None
                    or req.done):
                continue
            if req.handle.state == RequestState.QUEUED:
                try:
                    r.cancel(req.handle.rid)
                except Exception:
                    pass
                self._route(req, exclude={replica_id})
                if req.handle is not None:      # parked handoffs (no
                    # routable sibling) don't count as handoffs
                    self._c_requests.inc(replica=str(replica_id),
                                         outcome="drain_handoff")

    def undrain(self, replica_id: int) -> None:
        """Return a drained replica to rotation."""
        r = self.replicas[replica_id]
        r.draining = False
        r.drained_event_sent = False

    def eject_replica(self, replica_id: int, reason: str) -> None:
        """Operator/controller-initiated hard ejection: force the
        breaker open and run the standard ejection path — flight-
        recorder auto-dump, cancel + byte-identical mid-stream failover
        of every live request to siblings (parking them when none is
        routable, to be re-taken as replicas heal). The elastic resize
        controller calls this when a replica's TP mesh loses a chip:
        the torn mesh must stop serving NOW, exactly like a dead
        engine."""
        r = self.replicas[replica_id]
        r.health.force_eject(reason)
        self._eject(replica_id, r, reason)

    def invalidate_index(self, replica_id: int,
                         page_size: Optional[int] = None) -> None:
        """Drop the router-side prefix index slice for one replica: a
        replaced or mesh-resized replica starts with a COLD pool, so a
        surviving index entry would route affinity traffic to prefixes
        the new pool no longer holds (a stale hit costs a miss, but a
        systematic one defeats the affinity win). Called by
        :meth:`replace_replica` and the elastic resize controller."""
        ps = (page_size if page_size is not None
              else self.replicas[replica_id].engine.page_size)
        self._index[replica_id] = RadixTree(ps)

    def replace_replica(self, handle: ReplicaHandle) -> None:
        """Swap a fresh :class:`ReplicaHandle` (same id, new engine) into
        the fleet — the recovery path for a replica whose scheduler
        degraded, whose process died for real, or whose TP mesh resized
        under it. The router-side prefix index for that id resets (the
        new engine's cache is cold) and the reused id's
        ``paddle_serving_r<id>`` metrics namespace re-registers
        idempotently (the registry sink replaces; regression-tested)."""
        rid = handle.replica_id
        if rid not in self.replicas:
            raise KeyError(f"no replica {rid} in the fleet")
        live = [req for req in self._requests.values()
                if req.replica_id == rid and req.handle is not None
                and not req.done]
        if live:
            raise RuntimeError(
                f"replica {rid} still owns {len(live)} live requests; "
                "drain or eject it first")
        self.replicas[rid] = handle
        self.invalidate_index(rid, page_size=handle.engine.page_size)
        self._probe.pop(rid, None)

    def add_replica(self, handle: ReplicaHandle) -> None:
        """Grow the fleet: register a NEW replica id with a cold prefix
        index — the autoscaler's scale-up actuation. The handle must
        share the fleet's clock; it starts taking traffic on the next
        routing decision."""
        rid = handle.replica_id
        if rid in self.replicas:
            raise ValueError(f"replica {rid} already in the fleet "
                             "(use replace_replica to swap engines)")
        self.replicas[rid] = handle
        self._index[rid] = RadixTree(handle.engine.page_size)
        self._g_state.set(self._state_code(handle), replica=str(rid))

    def remove_replica(self, replica_id: int) -> None:
        """Shrink the fleet: deregister a replica that owns no live
        requests — the autoscaler's scale-down completion, after a
        graceful drain emptied it. Raises while anything is still
        assigned (drain first), and refuses to remove the last
        replica."""
        if replica_id not in self.replicas:
            raise KeyError(f"no replica {replica_id} in the fleet")
        if len(self.replicas) == 1:
            raise RuntimeError("cannot remove the last replica")
        live = [req for req in self._requests.values()
                if req.replica_id == replica_id and req.handle is not None
                and not req.done]
        if live:
            raise RuntimeError(
                f"replica {replica_id} still owns {len(live)} live "
                "requests; drain it first")
        self.replicas.pop(replica_id)
        self._index.pop(replica_id, None)
        self._probe.pop(replica_id, None)

    # -- observability ------------------------------------------------------

    def _state_code(self, r: ReplicaHandle) -> int:
        if r.draining:
            return 5 if r.drained_event_sent else 4
        return STATE_CODE[r.health.state]

    def fleet_health(self) -> str:
        """``ok`` | ``degraded`` | ``breached`` for /healthz: breached
        only when NO replica can take ANY traffic — a half-open replica
        counts, because it can take its probe and recovery REQUIRES that
        probe to be routed (reporting breached would let an upstream
        load balancer starve the probes and turn a recoverable outage
        permanent). Degraded while any replica is not plainly healthy."""
        routable = [r for r in self.replicas.values()
                    if (r.health.accepting
                        or r.health.state == ReplicaState.HALF_OPEN)
                    and not r.draining and not r.degraded]
        if not routable:
            return "breached"
        if any(r.health.state != ReplicaState.HEALTHY or r.draining
               or r.degraded for r in self.replicas.values()):
            return "degraded"
        return "ok"

    def statusz(self) -> Dict[str, Any]:
        """The fleet view for /statusz: per-replica scheduler + breaker
        state, routing counters, parked/probe bookkeeping."""
        out: Dict[str, Any] = {
            "steps": self._steps,
            "health": self.fleet_health(),
            "pending": self.pending,
            "parked": len(self._parked),
            "probes": {str(k): v for k, v in self._probe.items()},
            "counters": {
                "accepted_total": self.accepted_total,
                "failed_total": self.failed_total,
                "shed_total": self.shed_total,
            },
            "replicas": {str(rid): self.replicas[rid].statusz()
                         for rid in sorted(self.replicas)},
            "index_nodes": {str(rid): len(t)
                            for rid, t in self._index.items()},
        }
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.states()
        if self.signal_bus is not None:
            out["signals"] = self.signal_bus.values()
        return out

    def journal_topology(self) -> Dict[str, Any]:
        """The fleet half of a journal head frame: everything
        postmortem replay (``paddle_tpu/observability/replay.py``)
        needs to rebuild this
        router — its config plus each replica's engine geometry,
        generation defaults, scheduler and breaker configs. Pure
        configuration, no runtime state: replay reconstructs state by
        re-driving the journaled frames."""
        return {
            "router_kind": type(self).__name__,
            "config": asdict(self.config),
            "replicas": [self.replicas[rid].journal_spec()
                         for rid in sorted(self.replicas)],
        }

    def attach_signal_bus(self, bus=None, **bus_kw):
        """Wire the fleet sensor plane: a :class:`~paddle_tpu_torch.
        observability.signals.SignalBus` carrying fleet pending/parked
        plus per-replica queue depth, SLO burn and speculation
        acceptance, ticked once per router step while armed (see
        ``ServingScheduler.attach_signal_bus``). Re-attach after
        ``replace_replica`` so per-replica signals follow the new
        handle."""
        if bus is None:
            from ..observability.signals import SignalBus
            bus_kw.setdefault("clock", self._clock)
            bus = SignalBus(**bus_kw)
        bus.attach_router(self)
        self.signal_bus = bus
        return bus

    def make_slo_monitor(self, completion_target: float = 0.99,
                         **monitor_kw):
        """Fleet-completion SLO: at least ``completion_target`` of
        accepted requests must resolve without a terminal failure or
        shed. Failover and drain handoffs are remediation, not bad
        events — counting them would let the router's own recovery
        cascade into a breach (same exclusion the scheduler applies to
        its "slo" sheds). Ticks once per router step on the router's
        clock."""
        from ..observability.slo import SLOMonitor, ratio_objective
        monitor_kw.setdefault("clock", self._clock)
        monitor = SLOMonitor([ratio_objective(
            "fleet_completion",
            lambda: self.failed_total + self.shed_total,
            lambda: self.accepted_total,
            target=completion_target,
            description=f"{completion_target:.2%} of accepted requests "
                        "complete (failover remediation excluded)")],
            **monitor_kw)
        self.slo_monitor = monitor
        return monitor
