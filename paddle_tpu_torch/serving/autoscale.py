"""Signal-driven autoscaling: the SignalBus sensor plane closed into a
control loop — counterpart of ``paddle_tpu/serving/autoscale.py``.

The decision loop is a small state machine, evaluated once per
``interval_s`` on the router's clock:

::

    IDLE --(overload evidence x evidence_rounds)--> HOT
      HOT:  replicas < max and scale_up off cooldown  -> SCALE_UP
            else role imbalance and off cooldown      -> ROLE_CHANGE
    IDLE --(underload evidence x evidence_rounds)--> COLD
      COLD: replicas > min and scale_down off cooldown -> SCALE_DOWN
    any actuation in flight (drain pending)            -> HOLD

* **Evidence** maps the documented :class:`~paddle_tpu_torch.observability.
  signals.SignalSnapshot` contract to booleans: queue-depth level AND
  slope, SLO fast-burn, queue-wait share of e2e, paged-pool pressure,
  speculation-acceptance drift, and any parked (unroutable) request —
  the clearest scale-up signal there is.
* **Hysteresis**: evidence must hold ``evidence_rounds`` consecutive
  evaluations before anything actuates, and each action kind has its
  own ``cooldown_s``, so a spiky burst cannot thrash the fleet.
* **Actuation** uses the router's existing primitives, one operation at
  a time: scale-up builds a replica from the ``engine_factory`` /
  ``handle_factory`` pair (the :class:`~.elastic.
  ElasticServingController` recipe) and registers it with a role;
  scale-down and role flips go through drain → (retag|remove) →
  undrain, advanced across evaluation rounds — a flip never races live
  admissions, a removal never strands a request.

Every decision appends a versioned :class:`ScaleRecord` (bounded ring):
``autoscale.json`` in every flight-recorder bundle, the ``/scalez``
DiagServer endpoint, ``paddle_autoscale_decisions_total{action}`` +
``paddle_autoscale_replicas``, and ``scale_up`` / ``scale_down`` events
(``role_changed`` is emitted by the router's ``set_role``).
"""

from __future__ import annotations

import itertools
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..observability.events import emit_event
from ..observability.flight import flight_recorder
from ..observability.journal import journal, journal_armed
from ..observability.registry import get_registry
from ..observability.signals import SignalBus, SignalSnapshot
from .roles import ReplicaRole

#: bump when ScaleRecord gains/renames a field
SCALE_RECORD_VERSION = 1

#: process-global record sequence — reasons stay unique across
#: controller rebuilds in one process (same idiom as elastic's _ARC_SEQ)
_REC_SEQ = itertools.count(1)


@dataclass
class AutoscaleConfig:
    """Policy thresholds. "up_*" are overload evidence (any one
    suffices), "down_*" underload (all must hold). Depth thresholds are
    per-replica averages so they survive scale changes unchanged."""

    min_replicas: int = 1
    max_replicas: int = 8
    up_queue_depth: float = 4.0      # avg queued/replica, with rising slope
    up_trend: float = 0.0            # queue-depth slope floor (units/s)
    up_burn: float = 1.0             # SLO fast-window burn
    up_wait_share: float = 0.5       # queue_wait share of e2e
    up_pressure: float = 0.85        # paged-pool occupancy
    spec_drift: float = 0.3          # acceptance drop below 1 - drift
    down_queue_depth: float = 0.25   # avg queued/replica below = idle
    evidence_rounds: int = 2         # consecutive rounds before acting
    cooldown_s: float = 10.0         # per-action-kind
    rebalance_backlog: float = 2.0   # prefill-side avg depth to retag at


@dataclass
class Decision:
    """One policy verdict. ``replica_id``/``role`` carry the actuation
    target: the new replica's role for scale_up, the victim for
    scale_down, the flipped replica + its new role for role_change."""

    action: str                      # scale_up | scale_down | role_change
    reason: str
    replica_id: Optional[int] = None
    role: Optional[str] = None


@dataclass
class ScaleRecord:
    """One logged decision + its actuation timeline. ``snapshot`` is
    the exact :class:`SignalSnapshot` the policy decided on — a scaling
    postmortem replays the inputs, not a story about them."""

    schema_version: int
    seq: int
    t: float
    action: str
    reason: str
    replica_id: Optional[int]
    role: Optional[str]
    state: str                       # applying | done | failed
    phases: List[Dict[str, Any]] = field(default_factory=list)
    snapshot: Dict[str, Any] = field(default_factory=dict)

    def phase(self, name: str, t: float, **extra: Any) -> None:
        self.phases.append({"phase": name, "t": round(t, 6), **extra})

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


class AutoscalePolicy:
    """Pure decision function over (snapshot, roles): no router access,
    no side effects beyond its own hysteresis latches — unit-testable
    against synthetic snapshots."""

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = config or AutoscaleConfig()
        self._hot = 0                # consecutive overloaded rounds
        self._cold = 0               # consecutive idle rounds
        self._last: Dict[str, float] = {}    # action kind -> last t

    # -- evidence ------------------------------------------------------------

    def overload_evidence(self, snap: SignalSnapshot,
                          n_replicas: int) -> List[str]:
        cfg = self.config
        n = max(1, n_replicas)
        out = []
        if snap.parked > 0:
            out.append(f"parked={snap.parked:g}")
        if (snap.queue_depth / n >= cfg.up_queue_depth
                and snap.queue_depth_trend > cfg.up_trend):
            out.append(f"queue_depth/replica="
                       f"{snap.queue_depth / n:.2f} rising "
                       f"({snap.queue_depth_trend:+.3f}/s)")
        if snap.slo_fast_burn >= cfg.up_burn:
            out.append(f"slo_fast_burn={snap.slo_fast_burn:.2f}")
        if snap.queue_wait_share >= cfg.up_wait_share:
            out.append(f"queue_wait_share={snap.queue_wait_share:.2f}")
        if snap.page_pressure >= cfg.up_pressure:
            out.append(f"page_pressure={snap.page_pressure:.2f}")
        if snap.spec_acceptance <= 1.0 - cfg.spec_drift:
            out.append(f"spec_acceptance={snap.spec_acceptance:.2f}")
        return out

    def underload(self, snap: SignalSnapshot, n_replicas: int) -> bool:
        cfg = self.config
        n = max(1, n_replicas)
        return (snap.parked == 0
                and snap.queue_depth / n <= cfg.down_queue_depth
                and snap.slo_fast_burn < cfg.up_burn
                and snap.page_pressure < cfg.up_pressure)

    # -- role balance --------------------------------------------------------

    def _qd(self, snap: SignalSnapshot, rid: int) -> float:
        return snap.per_replica.get(f"r{rid}", {}).get("queue_depth", 0.0)

    def _routable(self, snap: SignalSnapshot, rid: int) -> bool:
        """Per-replica ``routable`` signal; missing reads as routable
        (a bus without the signal must not paralyze the policy)."""
        return snap.per_replica.get(f"r{rid}", {}).get(
            "routable", 1.0) >= 0.5

    def _rebalance(self, snap: SignalSnapshot,
                   roles: Dict[int, str]) -> Optional[Decision]:
        """Flip a replica toward the pressured phase. Prompt-heavy load
        queues on the prefill-capable side while decode replicas idle
        (handoff queues are shallow): promote the least-loaded DECODE.
        The reverse (decode side drowning, a PREFILL idle) demotes a
        surplus PREFILL — never the last one. Only ROUTABLE replicas
        count on either side: an ejected prefill replica is not idle
        prefill capacity, and flipping a dead replica actuates nothing."""
        cfg = self.config
        pre = [r for r, ro in roles.items()
               if ro in (ReplicaRole.PREFILL, ReplicaRole.HYBRID)
               and self._routable(snap, r)]
        dec = [r for r, ro in roles.items() if ro == ReplicaRole.DECODE
               and self._routable(snap, r)]
        pre_load = (sum(self._qd(snap, r) for r in pre) / len(pre)
                    if pre else 0.0)
        dec_load = (sum(self._qd(snap, r) for r in dec) / len(dec)
                    if dec else 0.0)
        if (dec and pre_load >= cfg.rebalance_backlog
                and pre_load > 2.0 * dec_load):
            rid = min(dec, key=lambda r: (self._qd(snap, r), r))
            return Decision(
                "role_change",
                f"prefill backlog {pre_load:.2f}/replica vs decode "
                f"{dec_load:.2f}: promote r{rid} to prefill",
                replica_id=rid, role=ReplicaRole.PREFILL)
        strict_pre = [r for r, ro in roles.items()
                      if ro == ReplicaRole.PREFILL]
        if (len(strict_pre) > 1 and dec_load >= cfg.rebalance_backlog
                and dec_load > 2.0 * pre_load):
            rid = min(strict_pre, key=lambda r: (self._qd(snap, r), r))
            return Decision(
                "role_change",
                f"decode backlog {dec_load:.2f}/replica vs prefill "
                f"{pre_load:.2f}: demote r{rid} to decode",
                replica_id=rid, role=ReplicaRole.DECODE)
        return None

    def _new_replica_role(self, snap: SignalSnapshot,
                          roles: Dict[int, str]) -> str:
        """A scale-up lands where the pressure is: prompt-heavy fleets
        grow the prefill side, otherwise the new capacity stays HYBRID
        (useful for both phases, handoff-eligible as a target)."""
        pre = [r for r, ro in roles.items()
               if ro in (ReplicaRole.PREFILL, ReplicaRole.HYBRID)
               and self._routable(snap, r)]
        dec = [r for r, ro in roles.items() if ro == ReplicaRole.DECODE
               and self._routable(snap, r)]
        pre_load = (sum(self._qd(snap, r) for r in pre) / len(pre)
                    if pre else 0.0)
        dec_load = (sum(self._qd(snap, r) for r in dec) / len(dec)
                    if dec else 0.0)
        if dec and pre_load > 2.0 * dec_load:
            return ReplicaRole.PREFILL
        return ReplicaRole.HYBRID

    # -- the verdict ---------------------------------------------------------

    def _cooled(self, action: str, t: float) -> bool:
        last = self._last.get(action)
        return last is None or t - last >= self.config.cooldown_s

    def decide(self, snap: SignalSnapshot, roles: Dict[int, str],
               t: float) -> Optional[Decision]:
        cfg = self.config
        n = len(roles)
        evidence = self.overload_evidence(snap, n)
        if evidence:
            self._hot += 1
            self._cold = 0
        elif self.underload(snap, n):
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        decision: Optional[Decision] = None
        if self._hot >= cfg.evidence_rounds:
            if n < cfg.max_replicas and self._cooled("scale_up", t):
                decision = Decision(
                    "scale_up", "; ".join(evidence),
                    role=self._new_replica_role(snap, roles))
            elif self._cooled("role_change", t):
                decision = self._rebalance(snap, roles)
        elif (self._cold >= cfg.evidence_rounds
                and n > cfg.min_replicas
                and self._cooled("scale_down", t)):
            # victim: the least-loaded replica, hybrids first (removing
            # one never unbalances the role split)
            order = {ReplicaRole.HYBRID: 0, ReplicaRole.DECODE: 1,
                     ReplicaRole.PREFILL: 2}
            rid = min(roles, key=lambda r: (order[roles[r]],
                                            self._qd(snap, r), r))
            decision = Decision(
                "scale_down",
                f"idle: queue_depth/replica="
                f"{snap.queue_depth / max(1, n):.2f}, parked=0",
                replica_id=rid)
        if decision is not None:
            self._last[decision.action] = t
            self._hot = self._cold = 0
        return decision


class AutoscaleController:
    """Applies :class:`AutoscalePolicy` verdicts to a live fleet. The
    router is any :class:`~.router.FleetRouter`; role actuation needs a
    :class:`~.roles.DisaggRouter` (a plain fleet is treated as all-
    HYBRID and only scales counts). ``engine_factory()`` builds a fresh
    engine, ``handle_factory(replica_id, engine)`` wraps it — the same
    split the elastic resize controller uses, so one pair of factories
    serves both controllers."""

    def __init__(self, router,
                 engine_factory: Callable[[], Any],
                 handle_factory: Callable[[int, Any], Any],
                 config: Optional[AutoscaleConfig] = None,
                 policy: Optional[AutoscalePolicy] = None,
                 bus: Optional[SignalBus] = None,
                 interval_s: float = 1.0,
                 max_records: int = 256):
        self.router = router
        self.engine_factory = engine_factory
        self.handle_factory = handle_factory
        self.policy = policy or AutoscalePolicy(config)
        self.config = self.policy.config
        if bus is None:
            bus = router.signal_bus
        if bus is None:
            bus = router.attach_signal_bus(interval_s=interval_s)
        self.bus = bus
        self._clock = router._clock
        self._interval = float(interval_s)
        self._last_eval: Optional[float] = None
        self._max_records = int(max_records)
        self.records: List[ScaleRecord] = []
        self._pending: List[Dict[str, Any]] = []     # drain ops in flight
        self.rounds = 0
        reg = get_registry()
        self._c_decisions = reg.counter(
            "paddle_autoscale_decisions_total",
            "autoscaler actuations by kind",
            labels=("action",))
        self._g_replicas = reg.gauge(
            "paddle_autoscale_replicas",
            "current fleet size under autoscaler control")
        self._g_replicas.set(len(router.replicas))
        # autoscale.json in every postmortem bundle (a later controller
        # replaces an earlier one, same lifecycle as attach_elastic)
        flight_recorder.attach_autoscale(self)

    # -- driving -------------------------------------------------------------

    def step(self, params) -> int:
        """One fleet round + one (decimated) control round — the drop-in
        replacement for ``router.step`` in a serving loop."""
        self.router.step(params)
        self.evaluate()
        return self.router.pending

    def run(self, params, max_steps: Optional[int] = None) -> None:
        """Drive until every request resolves (test/bench harness)."""
        steps = 0
        while self.router.pending:
            before = self.router.pending
            self.step(params)
            steps += 1
            if self.router.pending and max_steps is not None \
                    and steps >= max_steps:
                raise RuntimeError(
                    f"autoscale loop exceeded max_steps={max_steps} "
                    f"with {self.router.pending} requests pending")
            self.router._backoff_if_stalled(before)

    # -- the control loop ----------------------------------------------------

    def _roles(self) -> Dict[int, str]:
        roles = getattr(self.router, "roles", None)
        if roles is None:
            return {rid: ReplicaRole.HYBRID
                    for rid in self.router.replicas}
        return dict(roles)

    def evaluate(self) -> Optional[ScaleRecord]:
        """One control round: advance in-flight drains, then (at most
        once per ``interval_s``) snapshot the bus, ask the policy, and
        actuate. Returns the new record when a decision was made."""
        t = self._clock()
        self._advance_pending(t)
        if self._last_eval is not None \
                and t - self._last_eval < self._interval:
            return None
        self._last_eval = t
        self.rounds += 1
        # the controller is the bus's consumer: tick it here so the
        # control loop works with or without the history plane armed
        # (the router's own step-loop tick is gated on history_armed)
        self.bus.tick(now=t)
        if self._pending:
            return None          # one operation at a time (like elastic)
        snap = self.bus.snapshot_contract()
        decision = self.policy.decide(snap, self._roles(), t)
        if decision is None:
            return None
        rec = ScaleRecord(
            schema_version=SCALE_RECORD_VERSION, seq=next(_REC_SEQ),
            t=round(t, 6), action=decision.action, reason=decision.reason,
            replica_id=decision.replica_id, role=decision.role,
            state="applying", snapshot=snap.as_dict())
        self.records.append(rec)
        del self.records[:-self._max_records]
        self._c_decisions.inc(action=decision.action)
        if journal_armed[0]:
            # a scale frame in the journal is a replay *refusal* marker:
            # the fleet topology changed mid-incident, so the head frame
            # alone can no longer rebuild it. The frame carries the
            # ScaleRecord seq so the operator can pivot to autoscale.json.
            journal.note_scale(seq=rec.seq, action=rec.action,
                              reason=rec.reason, replica=rec.replica_id,
                              role=rec.role)
        try:
            self._apply(decision, rec, t)
        except Exception as e:  # noqa: BLE001 - a torn actuation must
            # not kill the serving loop; the record carries the autopsy
            rec.state = "failed"
            rec.phase("failed", t, error=repr(e))
        return rec

    def _apply(self, d: Decision, rec: ScaleRecord, t: float) -> None:
        router = self.router
        if d.action == "scale_up":
            new_rid = max(router.replicas) + 1
            engine = self.engine_factory()
            handle = self.handle_factory(new_rid, engine)
            rec.phase("built", self._clock(), replica=new_rid)
            if hasattr(router, "set_role"):
                router.add_replica(handle, role=d.role)
            else:
                router.add_replica(handle)
            rec.replica_id = new_rid
            # follow the fleet: per-replica signals for the new handle
            self.bus.attach_router(router)
            self._g_replicas.set(len(router.replicas))
            emit_event("scale_up", replica=new_rid, role=d.role,
                       replicas=len(router.replicas), reason=d.reason)
            rec.phase("added", self._clock(), role=d.role)
            rec.state = "done"
        elif d.action in ("scale_down", "role_change"):
            rid = d.replica_id
            router.drain(rid)
            rec.phase("drain", self._clock(), replica=rid)
            self._pending.append({"kind": d.action, "rid": rid,
                                  "role": d.role, "rec": rec})
        else:                                        # pragma: no cover
            raise ValueError(f"unknown action {d.action!r}")

    def _drained(self, rid: int) -> bool:
        r = self.router.replicas.get(rid)
        if r is None:
            return False
        if any(q.replica_id == rid and q.handle is not None
               for q in self.router._requests.values()):
            return False
        return r.pending == 0

    def _advance_pending(self, t: float) -> None:
        for op in list(self._pending):
            rid, rec = op["rid"], op["rec"]
            if rid not in self.router.replicas:
                # ejected/replaced under us: the op is moot
                self._pending.remove(op)
                rec.state = "failed"
                rec.phase("lost", t, replica=rid)
                continue
            if not self._drained(rid):
                continue
            self._pending.remove(op)
            if op["kind"] == "role_change":
                self.router.set_role(rid, op["role"], reason="autoscale")
                rec.phase("retag", t, role=op["role"])
                self.router.undrain(rid)
                rec.phase("undrain", t)
            else:
                self.router.remove_replica(rid)
                self._g_replicas.set(len(self.router.replicas))
                emit_event("scale_down", replica=rid,
                           replicas=len(self.router.replicas),
                           reason=rec.reason)
                rec.phase("removed", t)
            rec.state = "done"

    # -- observability -------------------------------------------------------

    def timeline_snapshot(self) -> Dict[str, Any]:
        """The ``autoscale.json`` bundle member / ``/scalez`` document:
        fleet shape, in-flight operations and the bounded decision
        ring."""
        return {
            "kind": "paddle_tpu.autoscale",   # the reference's format name
            "schema_version": SCALE_RECORD_VERSION,
            "replicas": len(self.router.replicas),
            "roles": {str(rid): role
                      for rid, role in sorted(self._roles().items())},
            "rounds": self.rounds,
            "pending_ops": [{"kind": op["kind"], "replica": op["rid"],
                             "role": op["role"]}
                            for op in self._pending],
            "config": asdict(self.config),
            "records": [r.as_dict() for r in self.records],
        }
