"""Per-replica failure detection: a circuit breaker over step outcomes —
counterpart of ``paddle_tpu/serving/health.py``.

The fleet router (:mod:`.router`) owns N engine replicas and needs a
local, deterministic answer to "is this replica safe to route to?". A
:class:`HealthTracker` derives it from two signals only — consecutive
step failures and a watchdog on the time since the last successful step
— through the classic circuit-breaker state machine:

``HEALTHY`` → (failures ≥ ``suspect_after``) → ``SUSPECT`` →
(failures ≥ ``eject_after``) → ``EJECTED`` → (``probe_cooldown_s``
elapses) → ``HALF_OPEN`` → one probe request → back to ``HEALTHY`` on
probe success, or back to ``EJECTED`` with the cooldown doubled on
probe failure (bounded by ``max_cooldown_s``).

* ``SUSPECT`` replicas still serve (the router deprioritizes them);
  one successful step returns them to ``HEALTHY``.
* ``EJECTED`` replicas receive no traffic at all.
* ``HALF_OPEN`` admits **exactly one** request — the probe. Only the
  probe *completing* closes the circuit (``record_probe_success``); a
  trivially successful idle step must not re-admit a replica whose
  failures show up only under load.

Time is an injected ``clock`` (the router shares one clock across the
fleet), so chaos tests driving a fake clock get byte-deterministic
transitions. The tracker holds no engine references — it is pure state,
and the router translates transitions into ejection/drain/failover.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional


class ReplicaState:
    """Circuit-breaker states (see module docstring)."""

    HEALTHY = "healthy"
    SUSPECT = "suspect"
    EJECTED = "ejected"
    HALF_OPEN = "half_open"


#: numeric codes for the ``paddle_router_replica_state`` gauge (the
#: router adds 4 for draining and 5 for fully drained replicas)
STATE_CODE: Dict[str, int] = {
    ReplicaState.HEALTHY: 0,
    ReplicaState.SUSPECT: 1,
    ReplicaState.EJECTED: 2,
    ReplicaState.HALF_OPEN: 3,
}


@dataclass
class HealthConfig:
    """Breaker thresholds.

    ``suspect_after``/``eject_after``: consecutive step failures before
    the respective transition. ``watchdog_s``: a replica with work
    pending and no successful step for this long counts one failure per
    check (None disables). ``probe_cooldown_s``: EJECTED → HALF_OPEN
    delay; each failed probe multiplies it by ``cooldown_multiplier`` up
    to ``max_cooldown_s``.
    """

    suspect_after: int = 1
    eject_after: int = 3
    watchdog_s: Optional[float] = None
    probe_cooldown_s: float = 1.0
    cooldown_multiplier: float = 2.0
    max_cooldown_s: float = 60.0


class HealthTracker:
    """See module docstring. One per :class:`~paddle_tpu_torch.serving.replica.
    ReplicaHandle`; every mutation returns the (possibly unchanged)
    state so the caller can act on transition edges."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or HealthConfig()
        if self.config.suspect_after > self.config.eject_after:
            raise ValueError("suspect_after must be <= eject_after")
        self._clock = clock
        self.state = ReplicaState.HEALTHY
        self.consecutive_failures = 0
        self.failures_total = 0
        self.ejections_total = 0
        self.last_failure: Optional[str] = None
        self.last_ok_t: float = clock()
        self._ejected_t: Optional[float] = None
        self._cooldown = self.config.probe_cooldown_s

    # -- signals ------------------------------------------------------------

    def record_success(self) -> str:
        """A step completed. Clears the failure streak; SUSPECT heals to
        HEALTHY. HALF_OPEN stays HALF_OPEN — only the probe request
        completing (:meth:`record_probe_success`) closes the circuit."""
        self.consecutive_failures = 0
        self.last_ok_t = self._clock()
        if self.state == ReplicaState.SUSPECT:
            self.state = ReplicaState.HEALTHY
        return self.state

    def record_probe_success(self) -> str:
        """The HALF_OPEN probe request completed: close the circuit and
        reset the cooldown backoff."""
        self.consecutive_failures = 0
        self.last_ok_t = self._clock()
        self.state = ReplicaState.HEALTHY
        self._cooldown = self.config.probe_cooldown_s
        self._ejected_t = None
        return self.state

    def record_failure(self, reason: str = "") -> str:
        """A step failed (raised / timed out / watchdog). HALF_OPEN goes
        straight back to EJECTED with the cooldown doubled."""
        cfg = self.config
        self.consecutive_failures += 1
        self.failures_total += 1
        self.last_failure = reason or None
        if self.state == ReplicaState.HALF_OPEN:
            self._eject()
            self._cooldown = min(self._cooldown * cfg.cooldown_multiplier,
                                 cfg.max_cooldown_s)
        elif self.state != ReplicaState.EJECTED:
            if self.consecutive_failures >= cfg.eject_after:
                self._eject()
            elif self.consecutive_failures >= cfg.suspect_after:
                self.state = ReplicaState.SUSPECT
        return self.state

    def force_eject(self, reason: str = "") -> str:
        """Immediate ejection regardless of the failure streak (the
        router uses this when a replica's scheduler degrades: that state
        is unrecoverable without a fresh engine)."""
        self.last_failure = reason or None
        self.failures_total += 1
        if self.state != ReplicaState.EJECTED:
            self._eject()
        return self.state

    def _eject(self) -> None:
        self.state = ReplicaState.EJECTED
        self.ejections_total += 1
        self._ejected_t = self._clock()

    def check_watchdog(self, busy: bool) -> bool:
        """True (and one failure recorded) when the replica has work but
        no successful step within ``watchdog_s``. Call once per router
        step, before stepping the replica."""
        w = self.config.watchdog_s
        if (w is None or not busy
                or self.state == ReplicaState.EJECTED):
            return False
        now = self._clock()
        if now - self.last_ok_t <= w:
            return False
        self.record_failure(f"watchdog: no successful step in {w:g}s")
        # restart the window: ONE failure per silent watchdog period —
        # without this, a replica whose steps also raise would be
        # double-charged every step and eject at half the configured
        # threshold
        self.last_ok_t = now
        return True

    def tick(self) -> str:
        """Advance the cooldown: EJECTED becomes HALF_OPEN once
        ``cooldown`` seconds have passed since ejection. The watchdog
        window restarts at that transition — ``last_ok_t`` froze while
        the replica sat ejected (unstepped), and judging the probe
        against that stale stamp would kill it before it ever ran."""
        if (self.state == ReplicaState.EJECTED
                and self._ejected_t is not None
                and self._clock() - self._ejected_t >= self._cooldown):
            self.state = ReplicaState.HALF_OPEN
            self.last_ok_t = self._clock()
        return self.state

    # -- derived ------------------------------------------------------------

    @property
    def accepting(self) -> bool:
        """Routable under normal policy (HALF_OPEN only takes the probe)."""
        return self.state in (ReplicaState.HEALTHY, ReplicaState.SUSPECT)

    @property
    def cooldown_s(self) -> float:
        return self._cooldown

    def snapshot(self) -> Dict[str, object]:
        """JSON-able state for /statusz and debug bundles."""
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "failures_total": self.failures_total,
            "ejections_total": self.ejections_total,
            "last_failure": self.last_failure,
            "cooldown_s": self._cooldown,
        }
