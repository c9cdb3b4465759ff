"""Robust anomaly detection over metric time series — counterpart of
``paddle_tpu/observability/anomaly.py``.

The stack's signals are heavy-tailed (step timings, queue depths, burn
rates), so mean/stddev detectors page on every compile stall. Everything
here is median/MAD based — the same robust z-score
``goodput.StragglerDetector`` kept private until this module generalised
it — plus a CUSUM change-point detector for the slow drifts a windowed
z-score never sees (each drifted sample looks ordinary against the
window that drifted with it; the *accumulated* deviation does not).

Detectors are pure sample-driven state machines:

* :class:`RobustZScoreDetector` — score each new sample against the
  PREVIOUS window's median/MAD (a level shift must not dilute its own
  baseline); fires on ``|z| > z_threshold``. Catches level shifts and
  spikes.
* :class:`CusumDetector` — freeze a baseline median/MAD over the warmup
  window, then accumulate one-sided standardized deviations
  (``g+ = max(0, g+ + z - k)``; symmetrically ``g-``); fire when either
  side exceeds ``h`` and re-baseline so a sustained shift fires ONCE.
  Catches slow drifts a z-score window absorbs.

:class:`AnomalyMonitor` runs named series through both, with a
**per-series cooldown** on the injected timeline so a sustained shift
pages once, emitting ``anomaly`` JSONL events and the
``paddle_anomaly_*`` families declared in :mod:`.catalog`.

Time discipline: this module NEVER reads a clock — callers pass the
sample timestamp in (the :class:`~.signals.SignalBus` passes its
injected clock's now), so detection is byte-deterministic under fake
clocks: the same series always yields the same events (as in
``slo.py`` and ``goodput.py``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from .events import emit_event
from .registry import get_registry

#: MAD -> stddev-equivalent scale for a normal distribution
MAD_SCALE = 1.4826


def _mid(ordered: Sequence[float]) -> float:
    """Median of an ALREADY-SORTED non-empty sequence."""
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


def median(values: Sequence[float]) -> float:
    """Median of a non-empty sequence (sorts a copy)."""
    return _mid(sorted(values))


def mad(values: Sequence[float], center: Optional[float] = None) -> float:
    """Median absolute deviation around ``center`` (default: the
    median)."""
    med = median(values) if center is None else center
    return _mid(sorted(abs(v - med) for v in values))


def robust_scale(values: Sequence[float],
                 center: Optional[float] = None) -> float:
    """MAD-derived scale with the degenerate-window fallback the
    straggler detector established: a perfectly uniform window (MAD 0)
    falls back to a fraction of the median so a genuine outlier still
    scores instead of dividing by zero."""
    med = median(values) if center is None else center
    m = mad(values, center=med)
    return MAD_SCALE * m if m > 0 else max(abs(med) * 0.05, 1e-12)


def robust_zscore(value: float, window: Sequence[float],
                  min_samples: int = 2) -> float:
    """Robust z of ``value`` against ``window`` (0 while the window is
    still warming up). THE shared primitive: ``goodput.
    StragglerDetector`` delegates here, so straggler flagging and series
    anomaly detection share one definition of "how unusual"."""
    if len(window) < min_samples:
        return 0.0
    ordered = sorted(window)
    med = _mid(ordered)
    m = _mid(sorted(abs(v - med) for v in ordered))
    scale = MAD_SCALE * m if m > 0 else max(abs(med) * 0.05, 1e-12)
    return (value - med) / scale


class RobustZScoreDetector:
    """Level-shift/spike detector; see module docstring. ``observe``
    returns a firing dict (score + direction) or None, and ALWAYS admits
    the sample afterwards — score-then-admit keeps an outlier from
    diluting the baseline it is judged against."""

    kind = "zscore"

    def __init__(self, window: int = 64, z_threshold: float = 6.0,
                 min_samples: int = 8):
        self.window = int(window)
        self.z_threshold = float(z_threshold)
        self.min_samples = max(2, int(min_samples))
        self._samples: Deque[float] = deque(maxlen=self.window)
        self.last_score = 0.0

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        value = float(value)
        window = self._samples
        if len(window) >= self.min_samples:
            ordered = sorted(window)
            med = _mid(ordered)
            m = _mid(sorted(abs(v - med) for v in ordered))
            if m == 0 and med == 0:
                # constant-ZERO window (an idle queue, a parked-count
                # series): no scale information at all — the straggler
                # fallback (a fraction of the median) degenerates to
                # ~1e-12 and the first real sample would score z~1e11.
                # The first activity on an idle series is a level
                # START, not an anomaly: admit it and let the window
                # build real statistics.
                z = 0.0
            else:
                scale = MAD_SCALE * m if m > 0 \
                    else max(abs(med) * 0.05, 1e-12)
                z = (value - med) / scale
        else:
            z = 0.0
        self.last_score = z
        window.append(value)
        if abs(z) <= self.z_threshold:
            return None
        return {"score": round(z, 4),
                "direction": "up" if z > 0 else "down"}


class CusumDetector:
    """Slow-drift change-point detector; see module docstring.

    ``k`` is the slack (in robust sigmas) ordinary noise may wander
    without charging the accumulator; ``h`` is the alarm threshold on
    the accumulated excess. After an alarm the detector re-baselines
    (fresh warmup window) so a series that settled at a new level does
    not page forever.
    """

    kind = "cusum"

    def __init__(self, k: float = 0.5, h: float = 8.0,
                 baseline: int = 24):
        self.k = float(k)
        self.h = float(h)
        self.baseline = max(4, int(baseline))
        self._warmup: List[float] = []
        self._center: Optional[float] = None
        self._scale = 1.0
        self.g_pos = 0.0
        self.g_neg = 0.0
        self.last_score = 0.0

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        value = float(value)
        if self._center is None:
            self._warmup.append(value)
            if len(self._warmup) >= self.baseline:
                med = median(self._warmup)
                if med == 0 and mad(self._warmup, center=med) == 0:
                    # constant-zero warmup: no scale to standardize by
                    # (same idle-series hazard as the z-score detector)
                    # — slide the window until real signal appears
                    self._warmup.pop(0)
                else:
                    self._center = med
                    self._scale = robust_scale(self._warmup, center=med)
                    self._warmup = []
            self.last_score = 0.0
            return None
        z = (value - self._center) / self._scale
        self.g_pos = max(0.0, self.g_pos + z - self.k)
        self.g_neg = max(0.0, self.g_neg - z - self.k)
        self.last_score = max(self.g_pos, self.g_neg)
        if self.g_pos <= self.h and self.g_neg <= self.h:
            return None
        fired = {"score": round(self.last_score, 4),
                 "direction": "up" if self.g_pos > self.g_neg
                 else "down"}
        # re-baseline: the shift is now the new normal — collect a fresh
        # warmup window instead of alarming on every subsequent sample
        self._center = None
        self._warmup = []
        self.g_pos = self.g_neg = 0.0
        return fired


def default_detectors() -> List[Any]:
    """One of each: the level-shift z-score and the drift CUSUM."""
    return [RobustZScoreDetector(), CusumDetector()]


class _Watch:
    __slots__ = ("name", "detectors", "cooldown_s", "last_fire_t",
                 "fired", "suppressed", "samples")

    def __init__(self, name: str, detectors: List[Any],
                 cooldown_s: float):
        self.name = name
        self.detectors = detectors
        self.cooldown_s = float(cooldown_s)
        self.last_fire_t: Optional[float] = None
        self.fired = 0
        self.suppressed = 0
        self.samples = 0


class AnomalyMonitor:
    """Cooldown + emission layer over per-series detectors (see module
    docstring). Thread-safe (the DiagServer scrape thread reads
    ``snapshot()`` while the serving loop observes)."""

    def __init__(self, cooldown_s: float = 60.0,
                 detector_factory=default_detectors,
                 recent_limit: int = 64):
        self._lock = threading.Lock()
        self._watches: Dict[str, _Watch] = {}
        self._cooldown_s = float(cooldown_s)
        self._factory = detector_factory
        self._recent: Deque[Dict[str, Any]] = deque(maxlen=recent_limit)
        reg = get_registry()
        self._c_events = reg.counter(
            "paddle_anomaly_events_total",
            "anomaly detections per series and detector (post-cooldown)",
            labels=("series", "detector"))
        self._g_score = reg.gauge(
            "paddle_anomaly_score",
            "latest robust anomaly score per watched series "
            "(max over detectors)", labels=("series",))

    def watch(self, series: str, detectors: Optional[List[Any]] = None,
              cooldown_s: Optional[float] = None) -> None:
        """Register ``series`` with explicit detectors/cooldown;
        ``observe`` auto-registers unknown series with the defaults."""
        with self._lock:
            self._watches[series] = _Watch(
                series, detectors if detectors is not None
                else self._factory(),
                self._cooldown_s if cooldown_s is None else cooldown_s)

    def observe(self, series: str, value: float, now: float
                ) -> List[Dict[str, Any]]:
        """Run one sample of ``series`` (taken at injected time ``now``)
        through its detectors. Returns the anomaly records EMITTED this
        sample (cooldown-suppressed detections return nothing but are
        counted in ``snapshot()``)."""
        with self._lock:
            w = self._watches.get(series)
            if w is None:
                w = self._watches[series] = _Watch(
                    series, self._factory(), self._cooldown_s)
            w.samples += 1
            fired: List[Dict[str, Any]] = []
            score = 0.0
            for det in w.detectors:
                hit = det.observe(value)
                score = max(score, abs(det.last_score))
                if hit is None:
                    continue
                if (w.last_fire_t is not None
                        and now - w.last_fire_t < w.cooldown_s):
                    w.suppressed += 1
                    continue
                record = {"series": series, "detector": det.kind,
                          "t": round(float(now), 6),
                          "value": round(float(value), 6), **hit}
                fired.append(record)
            if fired:
                # one cooldown window per SERIES: both detectors firing
                # on the same shift page together, then go quiet
                w.last_fire_t = now
                w.fired += len(fired)
                self._recent.extend(fired)
        self._g_score.set(score, series=series)
        for record in fired:
            self._c_events.inc(series=series, detector=record["detector"])
            emit_event("anomaly", **record)
        return fired

    # -- reading ------------------------------------------------------------

    def recent(self) -> List[Dict[str, Any]]:
        """Emitted anomaly records, oldest first (bounded ring)."""
        with self._lock:
            return list(self._recent)

    def snapshot(self) -> Dict[str, Any]:
        """Per-series state for /varz and ``history.json``."""
        with self._lock:
            return {w.name: {
                "samples": w.samples,
                "fired": w.fired,
                "suppressed": w.suppressed,
                "cooldown_s": w.cooldown_s,
                "last_fire_t": w.last_fire_t,
                "score": round(max((abs(d.last_score)
                                    for d in w.detectors), default=0.0),
                               4),
            } for w in self._watches.values()}
