"""Deterministic fault injection — counterpart of
``paddle_tpu/resilience/faults.py``. In the port the fleet router
(``replica_*`` events), the multi-host router (``host_*``, ``link_slow``)
and the training runtime (``durable``, ``ResilientTrainer``) ask it; the
elastic controller that asks for ``chip_*`` is not ported yet. The
schedule format stays the reference's, so one chaos repro drives either
package.

A :class:`FaultInjector` holds a *schedule* of faults — either written out
explicitly or generated from a seed — and the runtime asks it at
well-known points whether a fault fires:

===================  ======================================================
event                asked by
===================  ======================================================
``write_fail``       ``durable._commit`` before writing (mid-save crash:
                     raises IOError, leaving only partial staging litter)
``truncate_shard``   ``durable._commit`` after commit (bitrot/torn-disk
                     simulation: truncates a committed shard file in place)
``step_error``       ``ResilientTrainer`` before running a step (the step
                     raises; exercises bounded retry)
``preempt``          ``ResilientTrainer`` before running a step (SIGTERM
                     to self — the real preemption signal path)
``replica_die``      ``FleetRouter.step`` per replica (the replica raises
                     on every subsequent step — a dead engine)
``replica_stall``    ``FleetRouter.step`` per replica (the replica raises
                     for a bounded wall-clock window — a hung step the
                     watchdog would flag — then recovers)
``replica_slow``     ``FleetRouter.step`` per replica (each step sleeps
                     extra for a bounded window — a straggling replica)
``chip_die``         ``ElasticServingController.step`` per replica (one
                     chip of the replica's TP mesh dies: the replica is
                     hard-ejected, its flights fail over, and it
                     re-shards onto the surviving mesh)
``chip_degraded``    ``ElasticServingController.step`` per replica (a
                     chip must be retired but still answers: graceful
                     drain → re-shard → undrain, no failovers)
``host_die``         ``HostFleetRouter.step`` per host (the engine
                     PROCESS is killed: heartbeats stop, health walks
                     SUSPECT → EJECTED, flights fail over from their
                     snapshots)
``host_stall``       ``HostFleetRouter.step`` per host (the process
                     stops answering for a bounded window — missed
                     heartbeats without death — then recovers)
``link_slow``        ``HostFleetRouter.step`` per host (every transport
                     call to that host gains ``delay_s`` of injected
                     DCN latency for a bounded window)
===================  ======================================================

Each scheduled fault fires exactly once (``fire`` consumes it), so a
rollback-and-replay of the same step proceeds clean — which is what makes
chaos runs deterministic and byte-identical to uninterrupted ones. Tests
may schedule custom events (e.g. ``nan``) and query them from their own
step functions. ``fired`` records every (event, step) that triggered —
replica-scoped faults append ``(event, step, replica)``.

Replica scoping: a :class:`Fault` may carry a ``replica`` id. The router
asks ``fire(event, step, replica=r)`` for each replica every step; a
fault with ``replica=None`` acts as a wildcard (consumed by the first
replica that asks at its step), while a replica-scoped fault fires only
for its replica. The one-shot consumption contract is unchanged, so a
router chaos run replays byte-for-byte from the same schedule.

Chip scoping: chip-level events additionally carry a ``chip`` index into
the replica's TP mesh (``chip=None`` wildcards to whichever chip the
consumer defaults to — chip 0). The elastic controller asks
``fire_chip(event, step, replica=r)`` and receives the chip index, so a
seeded chip storm (``seeded_chips``) deterministically names WHICH chip
of WHICH replica dies at WHICH step.

Host scoping mirrors chip scoping one level up: a host-level event
carries a ``host`` id (an engine PROCESS, not a chip) and — for
``link_slow`` — a ``delay_s`` injected per-transport-call latency. The
multi-host router asks ``fire_host(event, step, host=h)`` and receives
the whole :class:`Fault` (it needs ``delay_s``); ``seeded_hosts``
generates reproducible host storms with the same one-per-target rule as
``seeded_chips``.

This module is also the only place allowed to write checkpoint bytes
outside the atomic-write helper — it exists to corrupt them on purpose.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class ChaosError(RuntimeError):
    """The injected step exception."""


#: JSON schema version for :meth:`FaultInjector.to_json` round-trips
FAULTS_SCHEMA_VERSION = 1

_FAULT_FIELDS = ("event", "step", "replica", "chip", "host", "delay_s")


def _fault_id(event: str, step: int, replica=None, chip=None,
              host=None) -> str:
    """Stable, human-greppable id for one firing: scope parts that
    don't apply render as ``-`` so ids align in logs."""
    return (f"{event}@s{int(step)}"
            f":r{replica if replica is not None else '-'}"
            f":c{chip if chip is not None else '-'}"
            f":h{host if host is not None else '-'}")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``event`` fires when the runtime reaches
    ``step`` (for save events, the step being saved). ``replica``
    narrows a fleet fault to one replica id (None = unscoped: trainer
    faults, or a wildcard consumed by the first replica that asks);
    ``chip`` narrows a chip-level event to one chip of that replica's
    TP mesh (None = the consumer's default chip)."""
    event: str
    step: int
    replica: Optional[int] = None
    chip: Optional[int] = None
    #: host (engine-process) id for host-level events; None = wildcard
    host: Optional[int] = None
    #: injected per-call transfer latency (seconds) for ``link_slow``
    delay_s: Optional[float] = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in _FAULT_FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        return cls(event=str(d["event"]), step=int(d["step"]),
                   replica=d.get("replica"), chip=d.get("chip"),
                   host=d.get("host"), delay_s=d.get("delay_s"))


@dataclass
class FaultInjector:
    schedule: List[Fault] = field(default_factory=list)
    #: (event, step) for unscoped faults, (event, step, replica) for
    #: replica-scoped ones — unpack accordingly when a schedule mixes both
    fired: List[Tuple] = field(default_factory=list)
    #: parallel record stream with STABLE ids + fully resolved scope
    #: (wildcards filled with the consumer that fired them) — the
    #: black-box journal's ``fault`` frames and :meth:`to_json` carry
    #: these; the legacy ``fired`` tuples stay unchanged for tests
    fired_records: List[dict] = field(default_factory=list)

    def _record_fired(self, f: Fault, replica=None, chip=None,
                      host=None) -> None:
        rec = {"id": _fault_id(f.event, f.step, replica, chip, host),
               "event": f.event, "step": int(f.step),
               "replica": replica, "chip": chip, "host": host,
               "delay_s": f.delay_s}
        self.fired_records.append(rec)
        try:        # chaos fires inside failure paths: a torn journal
            # tap must never break the injection itself
            from ..observability.journal import journal, journal_armed
            if journal_armed[0]:
                journal.note_fault(rec)
        except Exception:
            pass

    # -- JSON round-trip (sharing chaos repros; replay rebuilds) -----------

    def to_json(self) -> dict:
        """The injector as a JSON-able document: remaining schedule +
        resolved fired records, versioned for skew rejection."""
        return {"schema_version": FAULTS_SCHEMA_VERSION,
                "schedule": [f.as_dict() for f in self.schedule],
                "fired": [dict(r) for r in self.fired_records]}

    @classmethod
    def from_json(cls, doc: dict) -> "FaultInjector":
        ver = doc.get("schema_version")
        if ver != FAULTS_SCHEMA_VERSION:
            raise ValueError(
                f"fault schedule schema_version={ver!r}, this tree "
                f"speaks {FAULTS_SCHEMA_VERSION}")
        inj = cls(schedule=[Fault.from_dict(d)
                            for d in doc.get("schedule", [])])
        inj.fired_records = [dict(r) for r in doc.get("fired", [])]
        return inj

    @classmethod
    def seeded(cls, seed: int, num_steps: int,
               events: Sequence[str] = ("write_fail", "truncate_shard",
                                        "step_error", "preempt"),
               n_faults: int = 4) -> "FaultInjector":
        """A reproducible random schedule: same seed → same faults."""
        import numpy as np
        rng = np.random.RandomState(seed)
        steps = rng.choice(max(num_steps, 1), size=n_faults, replace=True)
        kinds = rng.choice(len(events), size=n_faults)
        faults = sorted((Fault(events[int(k)], int(s))
                         for s, k in zip(steps, kinds)),
                        key=lambda f: (f.step, f.event))
        return cls(schedule=list(faults))

    def pending(self, event: Optional[str] = None) -> List[Fault]:
        return [f for f in self.schedule
                if event is None or f.event == event]

    @classmethod
    def seeded_replicas(cls, seed: int, num_steps: int, num_replicas: int,
                        events: Sequence[str] = ("replica_die",
                                                 "replica_stall",
                                                 "replica_slow"),
                        n_faults: int = 2) -> "FaultInjector":
        """A reproducible replica-scoped schedule for router chaos runs:
        same seed → same (event, step, replica) triples. Steps are
        1-based (1..num_steps) to match ``FleetRouter.step`` numbering —
        the router increments its counter before asking, so a step-0
        fault could never fire. Triples are unique: the router consumes
        at most one (event, step, replica) per step, so a duplicate
        could never fire and would silently thin the chaos run."""
        import numpy as np
        rng = np.random.RandomState(seed)
        num_steps = max(num_steps, 1)
        num_replicas = max(num_replicas, 1)
        n_faults = min(n_faults, num_steps * len(events) * num_replicas)
        faults: List[Fault] = []
        seen = set()
        while len(faults) < n_faults:
            f = Fault(events[int(rng.choice(len(events)))],
                      int(rng.choice(num_steps)) + 1,
                      replica=int(rng.choice(num_replicas)))
            if f in seen:
                continue
            seen.add(f)
            faults.append(f)
        faults.sort(key=lambda f: (f.step, f.event, f.replica))
        return cls(schedule=faults)

    @classmethod
    def seeded_chips(cls, seed: int, num_steps: int, num_replicas: int,
                     num_chips: int,
                     events: Sequence[str] = ("chip_die",
                                              "chip_degraded"),
                     n_faults: int = 1) -> "FaultInjector":
        """A reproducible chip-scoped schedule for elastic-resize chaos
        runs: same seed → same (event, step, replica, chip) quadruples.
        Steps are 1-based like ``seeded_replicas`` (the controller
        increments its counter before asking). At most one chip event
        per replica is scheduled — a second loss would re-shard a
        replica twice, which the acceptance suite exercises explicitly
        rather than by accident."""
        import numpy as np
        rng = np.random.RandomState(seed)
        num_steps = max(num_steps, 1)
        num_replicas = max(num_replicas, 1)
        n_faults = min(n_faults, num_replicas)
        faults: List[Fault] = []
        used_replicas = set()
        while len(faults) < n_faults:
            f = Fault(events[int(rng.choice(len(events)))],
                      int(rng.choice(num_steps)) + 1,
                      replica=int(rng.choice(num_replicas)),
                      chip=int(rng.choice(max(num_chips, 1))))
            if f.replica in used_replicas:
                continue
            used_replicas.add(f.replica)
            faults.append(f)
        faults.sort(key=lambda f: (f.step, f.event, f.replica, f.chip))
        return cls(schedule=faults)

    @classmethod
    def seeded_hosts(cls, seed: int, num_steps: int, num_hosts: int,
                     events: Sequence[str] = ("host_die", "host_stall",
                                              "link_slow"),
                     n_faults: int = 1,
                     delay_s: float = 0.05) -> "FaultInjector":
        """A reproducible host-scoped schedule for multi-host chaos
        runs: same seed → same (event, step, host) triples, with
        ``link_slow`` faults carrying ``delay_s`` of injected transfer
        latency. Steps are 1-based like ``seeded_replicas``; at most
        one event per host (a host that died AND stalls is one arc the
        acceptance suite builds explicitly, not by collision)."""
        import numpy as np
        rng = np.random.RandomState(seed)
        num_steps = max(num_steps, 1)
        num_hosts = max(num_hosts, 1)
        n_faults = min(n_faults, num_hosts)
        faults: List[Fault] = []
        used_hosts = set()
        while len(faults) < n_faults:
            ev = events[int(rng.choice(len(events)))]
            f = Fault(ev, int(rng.choice(num_steps)) + 1,
                      host=int(rng.choice(num_hosts)),
                      delay_s=(float(delay_s) if ev == "link_slow"
                               else None))
            if f.host in used_hosts:
                continue
            used_hosts.add(f.host)
            faults.append(f)
        faults.sort(key=lambda f: (f.step, f.event, f.host))
        return cls(schedule=faults)

    def fire_host(self, event: str, step: int,
                  host: Optional[int] = None) -> Optional[Fault]:
        """One-shot host-level match: returns (and consumes) the
        scheduled :class:`Fault` — the caller reads ``delay_s`` off it —
        or None. A host-scoped fault must match the queried host, an
        unscoped one wildcards, a host-scoped fault never fires for an
        unscoped query; ``fired`` records (event, step, host)."""
        for f in self.schedule:
            if f.event != event or f.step != int(step):
                continue
            if f.host is not None and (host is None
                                       or int(host) != f.host):
                continue
            self.schedule.remove(f)
            h = f.host if f.host is not None else (
                int(host) if host is not None else None)
            self.fired.append((event, int(step), h))
            self._record_fired(f, host=h)
            return f
        return None

    def _match(self, event: str, step: int,
               replica: Optional[int]) -> Optional[Fault]:
        """One-shot schedule matching shared by :meth:`fire` and
        :meth:`fire_chip`: (event, step) must equal exactly; a
        replica-scoped fault must match the queried replica, an
        unscoped fault acts as a wildcard, and a replica-scoped fault
        never fires for an unscoped query. The matched fault is
        consumed (removed from the schedule)."""
        for f in self.schedule:
            if f.event != event or f.step != int(step):
                continue
            if f.replica is not None and (replica is None
                                          or int(replica) != f.replica):
                continue
            self.schedule.remove(f)
            return f
        return None

    def fire_chip(self, event: str, step: int,
                  replica: Optional[int] = None,
                  default_chip: int = 0) -> Optional[int]:
        """Like :meth:`fire` for chip-level events, returning WHICH chip
        the fault names (``default_chip`` for wildcard-chip faults) or
        None when nothing is scheduled. Consumption/one-shot/replica-
        wildcard semantics match :meth:`fire`; ``fired`` records the
        full (event, step, replica, chip) quadruple."""
        f = self._match(event, step, replica)
        if f is None:
            return None
        chip = f.chip if f.chip is not None else int(default_chip)
        r = f.replica if f.replica is not None else (
            int(replica) if replica is not None else None)
        self.fired.append((event, int(step), r, chip))
        self._record_fired(f, replica=r, chip=chip)
        return chip

    def fire(self, event: str, step: int,
             replica: Optional[int] = None) -> bool:
        """True (and consume) iff a fault for (event, step) is scheduled.
        With ``replica`` given, replica-scoped faults must match it
        exactly; unscoped faults act as a wildcard. A replica-scoped
        fault never fires for an unscoped query."""
        f = self._match(event, step, replica)
        if f is None:
            return False
        if replica is None and f.replica is None:
            self.fired.append((event, int(step)))
            self._record_fired(f)
        else:
            r = f.replica if f.replica is not None else int(replica)
            self.fired.append((event, int(step), r))
            self._record_fired(f, replica=r)
        return True

    # -- corruption tools (deliberately non-atomic writes) ------------------

    def leave_partial_staging(self, staging_dir: str) -> None:
        """Simulate a crash mid-save: a half-written shard in the staging
        dir that never gets committed."""
        os.makedirs(staging_dir, exist_ok=True)
        with open(os.path.join(staging_dir, "0_0.distcp.npz"), "wb") as f:
            f.write(b"PK\x03\x04 torn write, process died here")

    def truncate_shard(self, ckpt_dir: str) -> str:
        """Truncate a committed shard file to half its size, as a torn disk
        or partial upload would — the checkpoint must now fail checksum
        verification and be skipped on load."""
        shards = sorted(n for n in os.listdir(ckpt_dir)
                        if n.endswith(".distcp.npz"))
        if not shards:
            raise FileNotFoundError(f"no shard files under {ckpt_dir!r}")
        victim = os.path.join(ckpt_dir, shards[0])
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return victim
