"""SignalBus: named, smoothed, autoscaler-ready operational signals —
counterpart of ``paddle_tpu/observability/signals.py``.

The autoscaler policy (:mod:`..serving.autoscale`) wants a handful of scalar
decision inputs, not a metrics scrape: SLO burn trend per replica,
queue-depth slope, queue_wait's share of end-to-end latency, paged-pool
pressure, speculation acceptance drift. The :class:`SignalBus` is the
one place those are computed: each registered signal has a *reader*
(any callable returning a float over the live objects — scheduler,
router, registry gauges, the span collector), an EWMA-smoothed value,
and a windowed **trend** (units/second slope) from the bus's
:class:`~.timeseries.MetricHistory`. Every tick also feeds each
smoothed signal to the bus's :class:`~.anomaly.AnomalyMonitor`, so a
level shift or slow drift in any signal pages (once, per-series
cooldown) without a human staring at /metrics.

Surfaces:

* ``DiagServer /varz`` — the live signal document
  (:meth:`SignalBus.varz`);
* every flight-recorder bundle embeds :meth:`history_snapshot` as
  ``history.json`` (the bus attaches itself on construction, like the
  fleet router), so an ejection postmortem shows the minutes BEFORE the
  ejection, not just the moment of it;
* ``paddle_signal_value{signal=…}`` gauges keep the newest smoothed
  values on /metrics.

Driving: the serving scheduler / fleet router tick the bus once per
step — gated on ``timeseries.history_armed`` (one list index disarmed)
and decimated inside :meth:`tick` to ``interval_s`` — the same
zero-overhead contract as the flight recorder. Time is the injected
``clock`` only.
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .anomaly import AnomalyMonitor
from .memory import memory_ledger, pool_occupancy
from .registry import get_registry
from .timeline import span_collector, timeline_armed
from .timeseries import (HISTORY_SCHEMA_VERSION, MetricHistory,
                         history_armed)


class _Signal:
    __slots__ = ("name", "reader", "alpha", "raw", "smoothed", "detect",
                 "every", "errors")

    def __init__(self, name: str, reader: Callable[[], float],
                 alpha: float, detect: bool, every: int):
        self.name = name
        self.reader = reader
        self.alpha = float(alpha)
        self.raw: Optional[float] = None
        self.smoothed: Optional[float] = None
        self.detect = detect
        self.every = max(1, int(every))     # read every Nth bus tick
        self.errors = 0


def _max_fast_burn(monitor) -> float:
    """Worst fast-window burn across a monitor's objectives (0 when no
    monitor is attached yet — the signal exists from the start so its
    history has no gap to explain)."""
    if monitor is None:
        return 0.0
    return max((st["fast_burn"] for st in monitor.states()), default=0.0)


def _queue_wait_share(metrics) -> float:
    """queue_wait's share of end-to-end latency. Primary source: the
    span collector's critical-path attribution (exclusive segments of
    the slowest-request exemplars — already materialised on the cold
    read path, cached after first computation). Fallback when the
    timeline plane is disarmed: cumulative histogram sums from the
    serving sink."""
    if timeline_armed[0]:
        rows = span_collector.slowest(5)
        e2e = sum(r.get("e2e_ms", 0.0) for r in rows)
        if e2e > 0:
            qw = sum(r.get("segments", {}).get("queue_wait", 0.0)
                     for r in rows)
            return qw / e2e
    h_q = metrics.histograms.get("queue_wait_ms")
    h_e = metrics.histograms.get("e2e_ms")
    if h_q is None or h_e is None or h_e.sum <= 0:
        return 0.0
    return h_q.sum / h_e.sum


def _pool_pressure(engine) -> float:
    """Paged-pool pressure in [0, 1] off the engine's pool, via the
    memory ledger's ONE occupancy derivation
    (:func:`~.memory.pool_occupancy` — the scheduler's utilization
    gauges read the same split, so the autoscaler signal and /metrics
    can never disagree about what "full" means)."""
    return pool_occupancy(engine.mgr)["pressure"]


def _spec_acceptance(engine) -> float:
    spec = getattr(engine, "spec", None)
    if spec is None:
        return 1.0
    return float(spec.snapshot().get("acceptance_ratio", 1.0))


#: bump when :class:`SignalSnapshot` gains/renames a field — the
#: autoscaler refuses a mismatched document instead of mis-reading it
SIGNAL_SNAPSHOT_VERSION = 1


@dataclass(frozen=True)
class SignalSnapshot:
    """The autoscaler input contract, promoted from prose to
    code: ONE versioned document shared by the :class:`SignalBus`
    (:meth:`SignalBus.snapshot_contract`), every flight bundle's
    ``history.json`` (embedded as ``contract``) and
    ``AutoscalePolicy.decide`` — the three can no longer silently drift.

    Fleet-level fields aggregate whatever signal set is registered:
    a scheduler-attached bus reports its own ``queue_depth`` /
    ``page_pressure`` readers directly; a router-attached bus
    aggregates the per-replica ``r<id>.*`` signals (sum for depths,
    max for burn/pressure, min for acceptance). ``per_replica`` keeps
    the unaggregated per-replica values (keyed ``"r<id>"``) for
    policies that pick WHICH replica to act on."""

    schema_version: int
    t: float
    queue_depth: float          # fleet-total queued admissions
    queue_depth_trend: float    # units/second slope over the bus window
    queue_wait_share: float     # queue_wait's share of e2e latency
    page_pressure: float        # worst paged-pool occupancy in [0, 1]
    slo_fast_burn: float        # worst fast-window burn across objectives
    spec_acceptance: float      # worst speculation acceptance (1 = off)
    pending: float              # router pending (routed + parked)
    parked: float               # requests with NO routable replica
    per_replica: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "SignalSnapshot":
        ver = doc.get("schema_version")
        if ver != SIGNAL_SNAPSHOT_VERSION:
            raise ValueError(
                f"SignalSnapshot schema_version {ver!r} != "
                f"{SIGNAL_SNAPSHOT_VERSION} — refusing to mis-read a "
                "drifted contract")
        fields = {k: doc[k] for k in (
            "schema_version", "t", "queue_depth", "queue_depth_trend",
            "queue_wait_share", "page_pressure", "slo_fast_burn",
            "spec_acceptance", "pending", "parked")}
        per = {str(k): {str(s): float(x) for s, x in v.items()}
               for k, v in doc.get("per_replica", {}).items()}
        return cls(per_replica=per, **fields)

    @classmethod
    def from_bus(cls, bus: "SignalBus") -> "SignalSnapshot":
        vals = bus.values()

        def val(name: str, default: float = 0.0) -> float:
            e = vals.get(name)
            return default if e is None or e["value"] is None \
                else float(e["value"])

        def trend(name: str) -> float:
            e = vals.get(name)
            return 0.0 if e is None else float(e["trend_per_s"])

        per: Dict[str, Dict[str, float]] = {}
        for name, e in vals.items():
            head, dot, sig = name.partition(".")
            if (dot and head.startswith("r") and head[1:].isdigit()
                    and e["value"] is not None):
                per.setdefault(head, {})[sig] = float(e["value"])
        if "queue_depth" in vals:
            qd = val("queue_depth")
            qd_trend = trend("queue_depth")
        else:
            qd = sum(d.get("queue_depth", 0.0) for d in per.values())
            qd_trend = sum(trend(f"{r}.queue_depth") for r in per)
        if "page_pressure" in vals:
            pressure = val("page_pressure")
        else:
            pressure = max((d.get("page_pressure", 0.0)
                            for d in per.values()), default=0.0)
        burn = max([val("slo_burn")]
                   + [d.get("slo_burn", 0.0) for d in per.values()])
        acc = min([val("spec_acceptance", 1.0)]
                  + [d.get("spec_acceptance", 1.0)
                     for d in per.values()])
        return cls(
            schema_version=SIGNAL_SNAPSHOT_VERSION,
            t=round(bus._clock(), 6),
            queue_depth=qd, queue_depth_trend=qd_trend,
            queue_wait_share=val("queue_wait_share"),
            page_pressure=pressure, slo_fast_burn=burn,
            spec_acceptance=acc,
            pending=val("fleet.pending"), parked=val("fleet.parked"),
            per_replica=per)


class SignalBus:
    """See module docstring. One bus per serving process; construct with
    the SAME clock as the scheduler/router that ticks it so fake-clock
    tests stay deterministic end to end."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 interval_s: float = 1.0, window_s: float = 300.0,
                 history: Optional[MetricHistory] = None,
                 monitor: Optional[AnomalyMonitor] = None,
                 capacity: int = 512,
                 anomaly_cooldown_s: float = 60.0):
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._interval = float(interval_s)
        self.window_s = float(window_s)
        self.history = history if history is not None else MetricHistory(
            clock=self._clock, capacity=capacity,
            min_interval_s=interval_s)
        self.monitor = monitor if monitor is not None else AnomalyMonitor(
            cooldown_s=anomaly_cooldown_s)
        self._signals: Dict[str, _Signal] = {}
        self._last_tick: Optional[float] = None
        self.ticks = 0
        self._g_value = get_registry().gauge(
            "paddle_signal_value",
            "newest smoothed value per SignalBus signal",
            labels=("signal",))
        # history.json in every postmortem bundle (a later bus replaces
        # an earlier one, same lifecycle as attach_router)
        from .flight import flight_recorder
        flight_recorder.attach_signals(self)

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return history_armed[0]

    def arm(self) -> "SignalBus":
        """Arm the sensor plane (flips ``timeseries.history_armed`` —
        the cell the scheduler/router step loops gate their tick on)."""
        self.history.arm()
        return self

    def disarm(self) -> None:
        self.history.disarm()

    # -- registration -------------------------------------------------------

    def signal(self, name: str, reader: Callable[[], float],
               smooth: float = 0.3, detect: bool = True,
               cooldown_s: Optional[float] = None,
               every: int = 1) -> None:
        """Register signal ``name``. ``smooth`` is the EWMA alpha (1 =
        raw); ``detect=False`` keeps a signal out of the anomaly
        monitor (e.g. a value that legitimately jumps); ``every=N``
        evaluates an expensive reader on every Nth bus tick only (the
        smoothed value holds in between). Re-registering replaces the
        reader but keeps the history ring."""
        with self._lock:
            self._signals[name] = _Signal(name, reader, smooth,
                                          bool(detect), every)
        if detect and cooldown_s is not None:
            self.monitor.watch(name, cooldown_s=cooldown_s)

    def attach_scheduler(self, sched, prefix: str = "") -> "SignalBus":
        """Wire the standard single-replica signal set over a
        ``ServingScheduler``: queue depth (slope = the autoscaler's
        pressure trend), queue_wait share of e2e, paged-pool pressure,
        SLO fast burn, speculation acceptance. Also tracks the sink's
        TTFT histogram so ``/varz`` can answer "p95 TTFT over the last
        window"."""
        p = prefix
        m = sched.metrics
        self.signal(f"{p}queue_depth",
                    lambda: float(sched.queue_depth))
        # attribution share moves slowly and its reader walks the span
        # collector's slowest table — evaluate at 1/4 the bus rate
        self.signal(f"{p}queue_wait_share",
                    lambda: _queue_wait_share(m), every=4)
        self.signal(f"{p}page_pressure",
                    lambda: _pool_pressure(sched.engine))
        self.signal(f"{p}slo_burn",
                    lambda: _max_fast_burn(sched.slo_monitor))
        self.signal(f"{p}spec_acceptance",
                    lambda: _spec_acceptance(sched.engine))
        self.history.track_histogram(
            f"{p}ttft_ms", lambda: m.histograms["ttft_ms"])
        self.history.track_counter(
            f"{p}tokens_total",
            lambda: float(m.counters.get("tokens_generated_total", 0)))
        # the memory ledger's per-class byte levels ride the same rings
        # (mem.<class>_bytes series — "where did the bytes go, lately")
        memory_ledger.attach_history(self.history)
        return self

    def attach_router(self, router) -> "SignalBus":
        """Fleet signal set over a ``FleetRouter``: fleet pending /
        parked plus per-replica queue depth and SLO burn (the "burn
        trend per replica" the autoscale policy scales on). Re-attach
        after ``replace_replica`` so signals follow the new handle."""
        self.signal("fleet.pending", lambda: float(router.pending))
        self.signal("fleet.parked", lambda: float(router.parked))
        for rid in sorted(router.replicas):
            r = router.replicas[rid]
            self.signal(f"r{rid}.queue_depth",
                        lambda r=r: float(r.queue_depth))
            self.signal(f"r{rid}.slo_burn",
                        lambda r=r: _max_fast_burn(r.slo_monitor))
            self.signal(f"r{rid}.spec_acceptance",
                        lambda r=r: _spec_acceptance(r.engine))
            self.signal(f"r{rid}.page_pressure",
                        lambda r=r: _pool_pressure(r.engine))
            # unsmoothed 0/1: can this replica take traffic NOW? The
            # autoscaler's role-balance math weighs only routable
            # replicas (a dead prefill replica must not read as "idle
            # prefill capacity" and mask the backlog)
            self.signal(f"r{rid}.routable",
                        lambda r=r: float(r.health.accepting
                                          and not r.draining
                                          and not r.degraded),
                        smooth=1.0, detect=False)
        return self

    # -- the hot-path entry (callers gate on history_armed[0]) --------------

    def tick(self, now: Optional[float] = None) -> bool:
        """One sensor round: read every signal, smooth, append to
        history, publish gauges, run anomaly detection. Decimated to
        ``interval_s`` — a call inside the interval is one clock read +
        compare. Returns whether a round ran."""
        t = self._clock() if now is None else now
        if self._last_tick is not None \
                and t - self._last_tick < self._interval:
            return False
        with self._lock:
            if self._last_tick is not None \
                    and t - self._last_tick < self._interval:
                return False
            self._last_tick = t
            self.ticks += 1
            sigs = list(self._signals.values())
        # registry families first (one lock round inside the history)
        self.history.sample(now=t)
        tick_n = self.ticks
        updates: List[tuple] = []
        for s in sigs:
            if tick_n % s.every:
                if s.smoothed is not None:      # hold between reads
                    updates.append((s.name, s.smoothed, False))
                continue
            try:
                raw = float(s.reader())
            except Exception:   # a torn reader must not kill the loop
                s.errors += 1
                continue
            s.raw = raw
            s.smoothed = raw if s.smoothed is None \
                else s.alpha * raw + (1.0 - s.alpha) * s.smoothed
            updates.append((s.name, s.smoothed, s.detect))
        for name, value, detect in updates:
            self.history.note(name, value, now=t)
            self._g_value.set(value, signal=name)
            if detect:
                self.monitor.observe(name, value, t)
        return True

    # -- reading ------------------------------------------------------------

    def values(self) -> Dict[str, Dict[str, Any]]:
        """{signal: {value, raw, trend_per_s}} — the autoscaler input."""
        with self._lock:
            sigs = list(self._signals.values())
        out: Dict[str, Dict[str, Any]] = {}
        for s in sorted(sigs, key=lambda s: s.name):
            out[s.name] = {
                "value": None if s.smoothed is None
                else round(s.smoothed, 6),
                "raw": None if s.raw is None else round(s.raw, 6),
                "trend_per_s": round(
                    self.history.slope(s.name, self.window_s), 8),
                "errors": s.errors,
            }
        return out

    def varz(self) -> Dict[str, Any]:
        """The /varz document: signal values + trends, anomaly state,
        history status."""
        return {
            "armed": history_armed[0],
            "ticks": self.ticks,
            "interval_s": self._interval,
            "window_s": self.window_s,
            "signals": self.values(),
            "anomalies": {"recent": self.monitor.recent(),
                          "series": self.monitor.snapshot()},
            "history": self.history.snapshot_status(),
        }

    def snapshot_contract(self) -> SignalSnapshot:
        """The versioned autoscaler input document
        (:class:`SignalSnapshot`) over this bus's current values — what
        ``AutoscalePolicy.decide`` consumes and ``history.json``
        embeds."""
        return SignalSnapshot.from_bus(self)

    def history_snapshot(self) -> Dict[str, Any]:
        """The ``history.json`` bundle member: the trailing window of
        every series plus signal values and emitted anomalies — the
        "5 minutes before the ejection" an autoscaler postmortem (or a
        human) replays. Bounded by the history rings by construction."""
        return {
            "schema_version": HISTORY_SCHEMA_VERSION,
            "kind": "paddle_tpu.history",     # the reference's format name
            "generated_t": round(self._clock(), 6),
            "window_s": self.window_s,
            "signals": self.values(),
            "contract": self.snapshot_contract().as_dict(),
            "series": self.history.snapshot(self.window_s),
            "anomalies": self.monitor.recent(),
        }
