"""Elastic mesh resize: TP-sharded serving replicas that survive chip
loss — counterpart of ``paddle_tpu/serving/elastic.py``.

A multi-chip replica (``ContinuousBatchingEngine(mesh=...)``) is one
failure domain per CHIP, not per host: lose one chip of an mp=4 mesh and
the other three still hold 3/4 of the weights and 3/4 of every KV page —
useless alone (each holds only its GQA groups), but the host-side state
that DEFINES the replica (prompts, streamed tokens, page tables,
allocator books) is chip-agnostic. So a chip loss is survivable by
construction: checkpoint the live request state, re-shard onto the
surviving mesh, and replay — which is exactly the resilience layer's
elastic-restart shape (``ResilientTrainer`` resumes from host state),
applied to serving.

:class:`ElasticServingController` owns that arc for every replica of a
:class:`~.router.FleetRouter`. Two paths, one state machine::

    chip_die       (crash path — the chip is GONE mid-decode)
      chip_lost -> checkpoint flights -> eject (siblings absorb the
      flights via the byte-identical mid-stream failover; with no
      routable sibling they park) -> re-shard -> replace_replica ->
      rejoined (HEALTHY, routable)

    chip_degraded  (graceful path — the chip must be retired but still
      answers; ICI flaps, ECC pressure)
      chip_lost -> drain (queued requests hand off now, in-flight
      streams finish in place) -> drained -> re-shard ->
      replace_replica -> undrain -> rejoined

Re-sharding is a REBUILD, not a migration: the new engine's weights are
placed fresh on the surviving mesh (``models.llama.shard_params_tp``
from the same host params the serving loop passes every step) and its
KV pool starts cold — the router's prefix-index slice for the replica is
invalidated (``FleetRouter.invalidate_index``) so affinity can never
route to prefixes the new pool no longer holds. Because greedy decode is
prefix-deterministic, every absorbed flight's continuation is
byte-identical to an uninterrupted run, so a whole chip-loss storm ends
byte-identical to the fault-free run (the chaos acceptance suite asserts
it).

Chaos: a :class:`~paddle_tpu_torch.resilience.faults.FaultInjector` schedules
one-shot ``chip_die`` / ``chip_degraded`` events with (replica, chip)
addressing (``FaultInjector.seeded_chips``); :meth:`step` polls them
before each router round, so the whole die → re-shard → rejoin arc is
deterministic and replayable from a seed.

Telemetry: ``paddle_mesh_chips{replica}`` (current TP degree),
``paddle_mesh_resizes_total{replica}``,
``paddle_mesh_chip_faults_total{replica,kind}``; JSONL events
``chip_lost`` / ``mesh_resized``; every resize appends a
:class:`ResizeRecord` (phase timeline + checkpointed flight state)
served by :meth:`timeline_snapshot` and embedded as ``elastic.json`` in
every flight-recorder bundle — the chip-loss postmortem carries its own
resize timeline.

A serving mesh here is a ``parallel.mesh.ServingMesh``: the devices of
this process (the reference's one controller over its devices), so the
controller, the router and every replica run in one process, as in the
reference, and ``shrink_serving_mesh`` drops a chip by its index.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..observability.events import emit_event
from ..observability.flight import flight_recorder
from ..observability.registry import get_registry
from ..parallel.mesh import shrink_serving_mesh
from .replica import ReplicaHandle
from .router import FleetRouter

#: resize records kept in memory (oldest dropped; bundles persist them)
MAX_RESIZES = 64

#: process-global arc counter: the flight recorder dedupes auto_dump
#: reasons once-per-process, so bundle names must never collide even
#: across controllers (a later controller replaces an earlier one)
_ARC_SEQ = itertools.count(1)


@dataclass
class FlightSnapshot:
    """One live request's state, checkpointed at the moment of chip
    loss: the prompt, every token already streamed to the consumer and
    the page metadata its sequence held. This is the continuation basis
    the failover path resubmits (prompt + streamed, remaining budget) —
    recorded here so the resize timeline documents exactly what state
    survived the chip."""

    router_rid: int
    trace_id: str
    prompt: List[int]
    streamed: List[int]
    pages: int
    engine_rid: Optional[int] = None
    #: the request's RESOLVED SamplerConfig fields (seed already pinned
    #: by ``FleetRouter.submit``) — without them a migrated sampled
    #: stream would resume under a different PRNG lane and diverge
    sampler: Optional[Dict[str, Any]] = None
    #: tokens the grammar's DFA already consumed (== streamed at
    #: checkpoint time); the resume path fast-forwards the automaton
    #: through these so the constraint continues mid-match
    grammar_prefix: Optional[List[int]] = None

    def as_dict(self) -> Dict[str, Any]:
        return {"router_rid": self.router_rid, "trace_id": self.trace_id,
                "prompt_tokens": len(self.prompt),
                "streamed_tokens": len(self.streamed),
                "pages": self.pages, "engine_rid": self.engine_rid,
                "sampler": self.sampler,
                "grammar_prefix_tokens": (len(self.grammar_prefix)
                                          if self.grammar_prefix is not None
                                          else None)}


@dataclass
class ResizeRecord:
    """One chip-loss → rejoin arc (the resize state machine's log)."""

    replica: int
    chip: int
    kind: str                       # "die" | "degraded"
    from_chips: int
    to_chips: int = 0               # filled at re-shard
    step: int = 0                   # controller step the fault fired at
    phases: List[tuple] = field(default_factory=list)   # (phase, t)
    flights: List[FlightSnapshot] = field(default_factory=list)

    def phase(self, name: str, t: float) -> None:
        self.phases.append((name, float(t)))

    @property
    def done(self) -> bool:
        return bool(self.phases) and self.phases[-1][0] == "rejoined"

    def as_dict(self) -> Dict[str, Any]:
        return {"replica": self.replica, "chip": self.chip,
                "kind": self.kind, "from_chips": self.from_chips,
                "to_chips": self.to_chips, "step": self.step,
                "phases": [{"phase": p, "t": t} for p, t in self.phases],
                "flights": [f.as_dict() for f in self.flights]}


class ElasticServingController:
    """See module docstring.

    ``engine_factory(mesh)`` builds a fresh
    ``ContinuousBatchingEngine`` sharded over ``mesh`` (None = a
    single-chip engine — a 1-chip replica losing its only chip rebuilds
    in place, the "replacement chip arrived" story);
    ``handle_factory(replica_id, engine)`` wraps it into the
    :class:`~.replica.ReplicaHandle` the router owns (reusing the
    replica id — the ``paddle_serving_r<id>`` namespace re-registers
    idempotently). Both factories are the SAME ones that built the
    original fleet, so a resized replica differs from its predecessor
    only in mesh degree."""

    def __init__(self, router: FleetRouter,
                 engine_factory: Callable[[Optional[Any]], Any],
                 handle_factory: Callable[[int, Any], ReplicaHandle],
                 fault_injector=None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.engine_factory = engine_factory
        self.handle_factory = handle_factory
        self.injector = fault_injector
        self._clock = clock
        self._steps = 0
        #: graceful resizes waiting for their drain to complete
        self._graceful: Dict[int, ResizeRecord] = {}
        #: completed + in-progress resize records, oldest first. Each
        #: crash-path record checkpoints its flights' token state, so
        #: the log is bounded (oldest arcs dropped past MAX_RESIZES) —
        #: a long-lived fleet must not accumulate dead token lists.
        self.resizes: List[ResizeRecord] = []
        reg = get_registry()
        self._g_chips = reg.gauge(
            "paddle_mesh_chips",
            "current TP mesh degree per serving replica",
            labels=("replica",))
        self._c_resizes = reg.counter(
            "paddle_mesh_resizes_total",
            "elastic mesh resizes completed per replica "
            "(chip loss -> re-shard -> rejoin)",
            labels=("replica",))
        self._c_faults = reg.counter(
            "paddle_mesh_chip_faults_total",
            "chip-level faults handled per replica by kind "
            "(die = crash path, degraded = graceful drain path)",
            labels=("replica", "kind"))
        for rid, r in router.replicas.items():
            self._g_chips.set(r.engine.num_chips, replica=str(rid))
        # chip-loss postmortem bundles embed elastic.json (the resize
        # timeline + checkpointed flight state)
        flight_recorder.attach_elastic(self)

    # -- the fleet loop (wraps FleetRouter.step) -----------------------------

    def step(self, params) -> int:
        """One elastic fleet round: poll scheduled chip chaos, advance
        pending graceful drains to their re-shard, then run the router
        round. Returns the router's ``pending``. Step numbering is
        1-based and locksteps with the router's (this calls
        ``router.step`` exactly once), so ``FaultInjector.seeded_chips``
        schedules land on the same rounds as replica-scoped faults."""
        self._steps += 1
        if self.injector is not None:
            for rid in sorted(self.router.replicas):
                chip = self.injector.fire_chip("chip_die", self._steps,
                                               replica=rid)
                if chip is not None:
                    self.lose_chip(rid, chip)
                chip = self.injector.fire_chip("chip_degraded",
                                               self._steps, replica=rid)
                if chip is not None:
                    self.retire_chip(rid, chip)
        self._advance_graceful()
        return self.router.step(params)

    @property
    def resizing(self) -> bool:
        """True while any graceful resize is waiting out its drain
        (crash-path resizes complete synchronously inside :meth:`step`).
        The fleet-loop exit condition is
        ``not router.pending and not ctl.resizing``."""
        return bool(self._graceful)

    def run(self, params, max_steps: Optional[int] = None) -> None:
        """Drive :meth:`step` until every router request resolves AND
        every pending graceful resize has rejoined."""
        steps = 0
        while self.router.pending or self._graceful:
            before = self.router.pending
            self.step(params)
            steps += 1
            if max_steps is not None and steps >= max_steps and (
                    self.router.pending or self._graceful):
                raise RuntimeError(
                    f"elastic fleet loop exceeded max_steps={max_steps} "
                    f"with {self.router.pending} pending, "
                    f"{len(self._graceful)} resizes draining")
            self.router._backoff_if_stalled(before)

    # -- the two fault paths -------------------------------------------------

    def lose_chip(self, replica_id: int, chip: int) -> ResizeRecord:
        """Crash path: the chip is gone mid-decode. Checkpoint the live
        request state, hard-eject the replica (the router cancels +
        fails over every flight — siblings absorb them with
        byte-identical continuations, or they park until the rebuilt
        replica rejoins), then re-shard onto the surviving mesh and
        rejoin through ``replace_replica``. Synchronous: the replica is
        HEALTHY on the smaller mesh when this returns."""
        r = self.router.replicas[replica_id]
        now = self._clock()
        chip = self._clamp_chip(r, chip)
        stale = self._graceful.pop(replica_id, None)
        if stale is not None:
            # the crash supersedes a pending graceful drain: the rebuilt
            # replica gets a fresh, re-indexed mesh that already excludes
            # the dead chip, so the old record's chip address is void —
            # completing it would re-shard the new replica a second time
            # with a chip index from the old, larger mesh
            stale.phase("superseded", now)
        rec = ResizeRecord(replica=replica_id, chip=int(chip), kind="die",
                           from_chips=r.engine.num_chips,
                           step=self._steps)
        rec.phase("chip_lost", now)
        rec.flights = self._snapshot_flights(replica_id)
        rec.phase("checkpointed", self._clock())
        self.resizes.append(rec)
        self._c_faults.inc(replica=str(replica_id), kind="die")
        emit_event("chip_lost", replica=replica_id, chip=int(chip),
                   cause="die", chips=rec.from_chips,
                   inflight=len(rec.flights),
                   trace_ids=sorted(f.trace_id for f in rec.flights))
        # the torn mesh must stop serving NOW: any stray step raises,
        # exactly like a dead engine (deterministic-chaos surface)
        r.kill()
        self.router.eject_replica(replica_id,
                                  f"chip {int(chip)} lost (mesh torn)")
        rec.phase("ejected", self._clock())
        self._reshard(replica_id, rec)
        return rec

    def retire_chip(self, replica_id: int, chip: int) -> ResizeRecord:
        """Graceful path: the chip must be retired but still answers.
        Drain the replica (queued requests hand off to siblings now,
        in-flight streams finish in place — no failovers, no replayed
        tokens), then re-shard + undrain once the drain completes
        (:meth:`step` advances it)."""
        r = self.router.replicas[replica_id]
        chip = self._clamp_chip(r, chip)
        pending = self._graceful.get(replica_id)
        if pending is not None:
            # a drain is already waiting out its in-flight streams: chip
            # indices address the mesh that existed when the FIRST fault
            # fired, and the re-shard rebuilds the replica on a fresh,
            # re-indexed mesh — a second retirement cannot be resolved
            # against either mesh. Count the fault, annotate the pending
            # arc, and leave its record intact; the retirement must be
            # re-issued against the rebuilt mesh once this arc rejoins.
            pending.phase("coalesced", self._clock())
            self._c_faults.inc(replica=str(replica_id), kind="degraded")
            emit_event("chip_lost", replica=replica_id, chip=int(chip),
                       cause="degraded", chips=r.engine.num_chips,
                       inflight=r.inflight, coalesced=True, trace_ids=[])
            return pending
        rec = ResizeRecord(replica=replica_id, chip=int(chip),
                           kind="degraded",
                           from_chips=r.engine.num_chips,
                           step=self._steps)
        rec.phase("chip_lost", self._clock())
        self.resizes.append(rec)
        self._c_faults.inc(replica=str(replica_id), kind="degraded")
        emit_event("chip_lost", replica=replica_id, chip=int(chip),
                   cause="degraded", chips=rec.from_chips,
                   inflight=r.inflight, trace_ids=[])
        self.router.drain(replica_id)
        rec.phase("draining", self._clock())
        self._graceful[replica_id] = rec
        return rec

    @staticmethod
    def _clamp_chip(r: ReplicaHandle, chip) -> int:
        """Clamp a scheduled chip index into the replica's ACTUAL mesh
        degree. Chaos schedules address (replica, chip) approximately —
        a ``seeded_chips(num_chips=4)`` fault may land on a replica
        already resized to mp=2 — and an out-of-range index must hit a
        real chip (``shrink_serving_mesh`` rejects it otherwise, which
        would crash the controller instead of the chaos drill)."""
        return max(0, min(int(chip), r.engine.num_chips - 1))

    def _advance_graceful(self) -> None:
        for rid, rec in list(self._graceful.items()):
            r = self.router.replicas[rid]
            if r.pending:
                continue            # in-flight streams still finishing
            self._graceful.pop(rid)
            rec.phase("drained", self._clock())
            self._reshard(rid, rec)

    # -- re-shard + rejoin ---------------------------------------------------

    def _reshard(self, replica_id: int, rec: ResizeRecord) -> None:
        old = self.router.replicas[replica_id]
        was_draining = old.draining
        mesh = old.engine.mesh
        if mesh is not None and old.engine.num_chips > 1:
            nkv = old.engine.model_config.num_key_value_heads
            new_mesh = shrink_serving_mesh(mesh, rec.chip, nkv)
        else:
            # single-chip replica (mesh-less, or already resized down
            # to its degree-1 affinity mesh): no surviving mesh —
            # rebuild in place (the "replacement chip arrived" story)
            new_mesh = mesh
        engine = self.engine_factory(new_mesh)
        handle = self.handle_factory(replica_id, engine)
        self.router.replace_replica(handle)
        if was_draining:
            self.router.undrain(replica_id)
        rec.to_chips = engine.num_chips
        rec.phase("resharded", self._clock())
        self._g_chips.set(rec.to_chips, replica=str(replica_id))
        self._c_resizes.inc(replica=str(replica_id))
        emit_event("mesh_resized", replica=replica_id,
                   from_chips=rec.from_chips, to_chips=rec.to_chips,
                   cause=rec.kind, flights=len(rec.flights))
        rec.phase("rejoined", self._clock())
        del self.resizes[:-MAX_RESIZES]
        # the resize postmortem: one bundle per (replica, arc) embedding
        # elastic.json with this record (no-op unless armed w/ dump dir)
        flight_recorder.auto_dump(
            f"mesh_resized_r{replica_id}_{next(_ARC_SEQ)}")

    # -- views ---------------------------------------------------------------

    def _snapshot_flights(self, replica_id: int) -> List[FlightSnapshot]:
        out: List[FlightSnapshot] = []
        # same-package access to the router's live-request table (the
        # checkpoint must see requests BEFORE ejection tears them down)
        for req in self.router._requests.values():
            if (req.replica_id != replica_id or req.handle is None
                    or req.done):
                continue
            eng = self.router.replicas[replica_id].engine
            erid = req.handle.engine_rid
            pages = 0
            if erid is not None:
                pages = len(eng.mgr._tables.get(erid, ()))
            streamed = list(req.stream.tokens)
            samp = None
            if req.sampler is not None:
                samp = {"temperature": req.sampler.temperature,
                        "top_k": req.sampler.top_k,
                        "top_p": req.sampler.top_p,
                        "seed": req.sampler.seed}
            out.append(FlightSnapshot(
                router_rid=req.rid, trace_id=req.trace_id,
                prompt=[int(t) for t in req.prompt],
                streamed=streamed,
                pages=pages, engine_rid=erid,
                sampler=samp,
                grammar_prefix=(list(streamed)
                                if req.grammar is not None else None)))
        return out

    def timeline_snapshot(self) -> Dict[str, Any]:
        """The resize state machine's full log (``elastic.json`` in
        every flight bundle; mount on a DiagServer via
        ``srv.register("elastic", ctl.timeline_snapshot)`` if it has a
        provider registry, or read it off the bundle)."""
        return {
            "steps": self._steps,
            "chips": {str(rid): r.engine.num_chips
                      for rid, r in sorted(self.router.replicas.items())},
            "draining": sorted(self._graceful),
            "resizes": [rec.as_dict() for rec in self.resizes],
        }
