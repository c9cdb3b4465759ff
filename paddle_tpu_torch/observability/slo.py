"""Declarative SLOs evaluated as multi-window burn rates —
counterpart of ``paddle_tpu/observability/slo.py``.

An :class:`SLObjective` names a target ("95% of TTFTs under 200 ms",
"99% of submissions not shed") and a *sampler* that reads the CUMULATIVE
(bad, total) event counts from the metrics registry — histograms via
:func:`latency_objective` (bucket counts above a threshold), counters via
:func:`ratio_objective`. The :class:`SLOMonitor` snapshots every
objective once per ``tick()`` and judges health with the classic
multi-window burn-rate rule (Google SRE workbook ch. 5):

* ``burn = bad_fraction / error_budget`` over a window — burn 1.0 spends
  the budget exactly at the end of the SLO period, 10.0 spends it 10x
  too fast;
* a **breach** requires the FAST window (5m-equivalent by default) AND
  the SLOW window (1h-equivalent) both past the threshold, so a single
  slow request cannot page but a sustained regression pages quickly;
* **recovery** is when the fast window drops back under the threshold —
  the slow window is deliberately ignored there, or a recovered system
  would stay "breached" for the rest of the hour.

Time is an injected ``clock`` (seconds, monotonic). The scheduler passes
its OWN clock when it attaches a monitor, so tests driving a fake clock
get byte-deterministic breach/recover transitions — this module must
never read the wall clock itself (lint-enforced by
``tests/test_observability_lint.py``).

On every transition the monitor emits ``slo_breach``/``slo_recovered``
JSONL events and keeps ``paddle_slo_burn_rate{slo,window}`` and
``paddle_slo_budget_remaining{slo}`` gauges fresh; an ``on_breach``
callback lets the serving scheduler shed load the moment an objective
burns (see ``ServingScheduler.attach_slo_monitor``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..core.histogram import Histogram
from .events import emit_event
from .flight import flight_armed, flight_recorder
from .registry import get_registry


@dataclass
class SLObjective:
    """One objective: ``target`` fraction of events must be good.

    ``sample()`` returns cumulative ``(bad, total)`` counts since process
    start; the monitor differentiates them over its windows. ``target``
    is the good-ratio promise (0.95 = "95% good"); the error budget is
    ``1 - target``.
    """

    name: str
    sample: Callable[[], Tuple[float, float]]
    target: float = 0.95
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: target must be in (0, 1) — a target "
                f"of 1.0 has zero error budget and every bad event would "
                f"be an infinite burn rate (got {self.target})")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def hist_count_le(h: Histogram, threshold: float) -> float:
    """Samples at or below ``threshold`` from a fixed-bucket histogram.
    Exact when ``threshold`` equals a bucket bound; otherwise the count
    through the last bound <= threshold (conservative: the straddling
    bucket counts as bad)."""
    good = 0
    for bound, n in zip(h.bounds, h.bucket_counts):
        if bound > threshold:
            break
        good += n
    return float(good)


def latency_objective(name: str, hist_fn: Callable[[], Histogram],
                      threshold_ms: float, target: float = 0.95,
                      description: str = "") -> SLObjective:
    """"``target`` of latencies under ``threshold_ms``" over a live
    histogram (e.g. the serving sink's ``ttft_ms``). Pick a threshold on
    a bucket bound of the histogram for exact accounting."""

    def sample() -> Tuple[float, float]:
        h = hist_fn()
        total = float(h.count)
        return total - hist_count_le(h, threshold_ms), total

    return SLObjective(name, sample, target=target,
                       description=description
                       or f"p{target * 100:g} {name} < {threshold_ms:g} ms")


def ratio_objective(name: str, bad_fn: Callable[[], float],
                    total_fn: Callable[[], float], target: float = 0.99,
                    description: str = "") -> SLObjective:
    """"At most ``1 - target`` of events bad" over two cumulative
    counters (e.g. shed+failed over submitted)."""
    return SLObjective(
        name, lambda: (float(bad_fn()), float(total_fn())), target=target,
        description=description or f"bad ratio of {name} < {1 - target:g}")


class _ObjectiveState:
    """Rolling (t, bad, total) samples + breach latch for one objective."""

    __slots__ = ("objective", "samples", "breached", "fast_burn",
                 "slow_burn", "budget_remaining", "breach_count",
                 "fast_events")

    def __init__(self, objective: SLObjective):
        self.objective = objective
        self.samples: Deque[Tuple[float, float, float]] = deque()
        self.breached = False
        self.fast_burn = 0.0
        self.slow_burn = 0.0
        self.budget_remaining = 1.0
        self.breach_count = 0
        self.fast_events = 0.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "slo": self.objective.name,
            "description": self.objective.description,
            "target": self.objective.target,
            "breached": self.breached,
            "breach_count": self.breach_count,
            "fast_burn": round(self.fast_burn, 4),
            "slow_burn": round(self.slow_burn, 4),
            "budget_remaining": round(self.budget_remaining, 4),
        }


class SLOMonitor:
    """Evaluates a set of objectives each ``tick()`` (see module
    docstring). Drive it from the serving/training step loop; health is
    derived state, never a side channel:

    * ``breached`` — some objective's fast AND slow burns exceed the
      threshold (latched until the fast window recovers);
    * ``degraded`` — some fast window is burning but the slow window has
      not confirmed yet (early warning, no page);
    * ``ok`` — otherwise.

    ``min_events`` is the traffic floor: an objective cannot breach (or
    report degraded) until its fast window holds at least that many
    events, so a handful of cold-start compile latencies or one stray
    error in near-zero traffic never pages.
    """

    def __init__(self, objectives: List[SLObjective],
                 clock: Optional[Callable[[], float]] = None,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_threshold: float = 10.0,
                 min_events: int = 5,
                 eval_interval_s: Optional[float] = None,
                 on_breach: Optional[Callable[[str, dict], None]] = None,
                 on_recover: Optional[Callable[[str, dict], None]] = None):
        if fast_window_s >= slow_window_s:
            raise ValueError("fast_window_s must be < slow_window_s")
        self.objectives = list(objectives)
        self._clock = clock if clock is not None else time.monotonic
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        # evaluation granularity: burn windows span minutes, so judging
        # them more than ~120x per fast window adds nothing — a tick
        # arriving earlier than this after the last evaluation returns
        # after ONE clock read + compare. This is what keeps a kHz step
        # loop's per-step cost flat (bench_obs_overhead.py) and bounds
        # sample retention to ~120 per fast window.
        self._min_gap = (self.fast_window_s / 120.0
                         if eval_interval_s is None
                         else float(eval_interval_s))
        self._last_eval: Optional[float] = None
        self.burn_threshold = float(burn_threshold)
        self.min_events = int(min_events)
        self.on_breach = on_breach
        self.on_recover = on_recover
        self._states: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState(o) for o in self.objectives}
        if len(self._states) != len(self.objectives):
            raise ValueError("duplicate SLO names")
        # O(1) mirror of "any objective breached": the serving loop asks
        # every step (level-triggered queue trimming), so the answer must
        # not cost a pass over the states dict per step
        self._breached_count = 0
        # seed a baseline sample per objective at construction, so events
        # between now and the first tick are counted (window deltas are
        # sample-to-sample; without a baseline the first tick's state
        # would silently become the zero point)
        t0 = self._clock()
        for st in self._states.values():
            try:
                bad, total = st.objective.sample()
                st.samples.append((t0, float(bad), float(total)))
            except Exception:
                pass
        reg = get_registry()
        self._g_burn = reg.gauge(
            "paddle_slo_burn_rate",
            "error-budget burn rate per objective and window",
            labels=("slo", "window"))
        self._g_budget = reg.gauge(
            "paddle_slo_budget_remaining",
            "fraction of the slow-window error budget left (1 = untouched)",
            labels=("slo",))
        self._g_breached = reg.gauge(
            "paddle_slo_breached",
            "1 while the objective is in breach", labels=("slo",))
        self._c_breaches = reg.counter(
            "paddle_slo_breaches_total",
            "breach transitions per objective", labels=("slo",))

    # -- evaluation ---------------------------------------------------------

    def tick(self) -> None:
        """Sample every objective at the injected clock's now and update
        burn rates, gauges, breach latches and callbacks. Called once per
        scheduler/training step; evaluations are decimated to the
        ``eval_interval_s`` granularity (ticks in between are one clock
        read + compare — the per-step overhead budgeted by
        ``benchmarks/bench_obs_overhead.py``), and the window math is ONE
        bounded reversed pass over the retained samples per objective."""
        now = self._clock()
        if self._last_eval is not None \
                and now - self._last_eval < self._min_gap:
            return
        self._last_eval = now
        fast_cut = now - self.fast_window_s
        slow_cut = now - self.slow_window_s
        for st in self._states.values():
            obj = st.objective
            try:
                bad, total = obj.sample()
            except Exception:       # a torn sampler must not kill the loop
                continue
            newest = (now, float(bad), float(total))
            st.samples.append(newest)   # appends are >= _min_gap apart
            # by the decimation above, so retention is bounded
            # keep one sample older than the slow window as its baseline
            while len(st.samples) > 2 and st.samples[1][0] < slow_cut:
                st.samples.popleft()
            # window baselines: the slow one is samples[1] by the pruning
            # invariant (O(1)); the fast one is a bounded backward scan
            # (<= ~120 coalesced samples per fast window)
            if st.samples[0][0] >= slow_cut:     # run shorter than window
                slow_old = st.samples[0]
            elif len(st.samples) > 1:
                slow_old = st.samples[1]
            else:
                slow_old = newest
            fast_old = newest
            for s in reversed(st.samples):
                if s[0] < fast_cut:
                    break
                fast_old = s
            budget = obj.budget
            d_total = newest[2] - fast_old[2]
            st.fast_events = d_total
            st.fast_burn = ((newest[1] - fast_old[1]) / d_total / budget
                            if d_total > 0 else 0.0)
            d_total = newest[2] - slow_old[2]
            if d_total > 0:
                st.slow_burn = (newest[1] - slow_old[1]) / d_total / budget
                st.budget_remaining = max(0.0, min(1.0, 1.0 - (
                    (newest[1] - slow_old[1]) / (d_total * budget))))
            else:
                st.slow_burn = 0.0
                st.budget_remaining = 1.0
            self._g_burn.set(st.fast_burn, slo=obj.name, window="fast")
            self._g_burn.set(st.slow_burn, slo=obj.name, window="slow")
            self._g_budget.set(st.budget_remaining, slo=obj.name)
            if flight_armed[0]:
                flight_recorder.note_metrics(obj.name, {
                    "t": now, "fast_burn": st.fast_burn,
                    "slow_burn": st.slow_burn, "bad": bad, "total": total})
            self._transition(st)
        # resync the O(1) mirror from the states (covers tests/tools
        # that latch st.breached directly, bypassing _transition); this
        # runs once per EVALUATED tick, so the per-step cost of
        # breached() stays one integer compare
        self._breached_count = sum(
            1 for st in self._states.values() if st.breached)

    def _transition(self, st: _ObjectiveState) -> None:
        thr = self.burn_threshold
        obj = st.objective
        if not st.breached and st.fast_events < self.min_events:
            # traffic floor: a couple of cold-start or stray events must
            # not page (standard low-traffic burn-rate suppression)
            return
        if not st.breached and st.fast_burn > thr and st.slow_burn > thr:
            st.breached = True
            self._breached_count += 1
            st.breach_count += 1
            self._g_breached.set(1.0, slo=obj.name)
            self._c_breaches.inc(slo=obj.name)
            emit_event("slo_breach", slo=obj.name,
                       fast_burn=round(st.fast_burn, 3),
                       slow_burn=round(st.slow_burn, 3),
                       budget_remaining=round(st.budget_remaining, 4),
                       target=obj.target)
            if self.on_breach is not None:
                self.on_breach(obj.name, st.to_dict())
        elif st.breached and st.fast_burn <= thr:
            st.breached = False
            self._breached_count -= 1
            self._g_breached.set(0.0, slo=obj.name)
            emit_event("slo_recovered", slo=obj.name,
                       fast_burn=round(st.fast_burn, 3),
                       slow_burn=round(st.slow_burn, 3))
            if self.on_recover is not None:
                self.on_recover(obj.name, st.to_dict())

    # -- derived state ------------------------------------------------------

    def health(self) -> str:
        """``breached`` | ``degraded`` | ``ok`` (see class docstring)."""
        states = self._states.values()
        if self._breached_count > 0:
            return "breached"
        if any(st.fast_burn > self.burn_threshold
               and st.fast_events >= self.min_events for st in states):
            return "degraded"
        return "ok"

    def breached(self, name: Optional[str] = None) -> bool:
        if name is not None:
            return self._states[name].breached
        return self._breached_count > 0      # O(1): per-step hot path

    def states(self) -> List[Dict[str, object]]:
        """JSON-able per-objective state (statusz / debug bundles)."""
        return [st.to_dict() for st in self._states.values()]
