"""Bounded metric time series: the memory the instantaneous stack lacks —
counterpart of ``paddle_tpu/observability/timeseries.py``.

The registry, SLO monitor and ``/statusz`` answer "what is true now";
the autoscaler policy and the fusion pass's regression gate need
"what has been true lately and which way is it
moving". :class:`MetricHistory` is that memory: a per-family ring-buffer
sampler over the existing :class:`~.registry.MetricsRegistry` (and any
sink-owned ``core.histogram.Histogram``), with windowed derivations —
counters materialise as **rates**, gauges as **levels + slopes**,
histograms as **windowed quantile estimates** (bucket-count deltas
between the window's endpoints, interpolated) — so cumulative families
become the trend signals a controller can act on.

Discipline (same contracts as the rest of the telemetry layer):

* **injected step-driven clocks only** — the constructor takes a
  ``clock`` and never reads the wall clock itself (tpu-lint
  ``layer-wall-clock``, the ``slo.py``/``goodput.py`` rule, covers this
  module too), so history windows are byte-deterministic in fake-clock
  tests and chaos replays;
* **one lock round per sample** — ``sample()`` reads every tracked
  reader and appends every ring inside a single ``with self._lock``;
* **zero-cost disarmed gate** — hot paths check the module-cell
  ``history_armed`` (one list index, no allocation) exactly like
  ``flight.flight_armed`` / ``runtime.dispatch_armed``; armed overhead
  rides under ``benchmarks/bench_obs_overhead.py``'s 3% budget;
* **decimation** — ``sample()`` returns after one clock compare when
  called again within ``min_interval_s``, so a kHz step loop costs a
  comparison, not a scrape.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

#: the one cell step loops check before ticking a sampler/bus (mutable
#: list so callers read a stable module attribute, not a rebindable name)
history_armed = [False]

#: ``history.json`` / snapshot schema version (bump on breaking changes)
HISTORY_SCHEMA_VERSION = 1


class _Series:
    __slots__ = ("name", "kind", "reader", "ring", "errors")

    def __init__(self, name: str, kind: str,
                 reader: Optional[Callable[[], Any]], capacity: int):
        self.name = name
        self.kind = kind                    # counter | gauge | histogram
        self.reader = reader                # None: push-only (note())
        self.ring: Deque[tuple] = deque(maxlen=capacity)
        self.errors = 0


def _hist_state(h) -> Tuple[float, float, Tuple[int, ...],
                            Tuple[float, ...]]:
    """(count, sum, bucket_counts, bounds) of a ``core.histogram.
    Histogram`` — the cumulative state windowed quantiles difference."""
    return (float(h.count), float(h.sum), tuple(h.bucket_counts),
            tuple(h.bounds))


class MetricHistory:
    """See module docstring. ``track_*`` registers readers; ``sample()``
    is the one hot-path entry; everything else is the cold read side."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 capacity: int = 512, min_interval_s: float = 1.0):
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._min_interval = float(min_interval_s)
        self._series: Dict[str, _Series] = {}
        self._last_sample: Optional[float] = None
        self.samples = 0

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return history_armed[0]

    def arm(self) -> "MetricHistory":
        history_armed[0] = True
        return self

    def disarm(self) -> None:
        history_armed[0] = False

    # -- registration -------------------------------------------------------

    def _track(self, name: str, kind: str,
               reader: Optional[Callable[[], Any]]) -> None:
        with self._lock:
            if name not in self._series:
                self._series[name] = _Series(name, kind, reader,
                                             self._capacity)

    def track_counter(self, name: str, reader: Callable[[], float]
                      ) -> None:
        """Track a CUMULATIVE count (``reader`` returns the running
        total — e.g. ``lambda: counter.total``); windows read as rates
        via :meth:`rate`."""
        self._track(name, "counter", reader)

    def track_gauge(self, name: str, reader: Callable[[], float]) -> None:
        """Track a level (``reader`` returns the current value); windows
        read as :meth:`latest` / :meth:`mean` / :meth:`slope`."""
        self._track(name, "gauge", reader)

    def track_histogram(self, name: str, hist_fn: Callable[[], Any]
                        ) -> None:
        """Track a live ``core.histogram.Histogram`` (e.g. a
        ``ServingMetrics`` family); windows read as
        :meth:`window_quantile` / :meth:`window_mean`."""
        self._track(name, "histogram", hist_fn)

    def note(self, name: str, value: float,
             now: Optional[float] = None) -> None:
        """Push one gauge-kind point directly (the SignalBus feeds its
        smoothed signals this way — no reader round-trip)."""
        t = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series(name, "gauge", None,
                                                 self._capacity)
            s.ring.append((t, float(value)))

    # -- sampling (the hot-path entry; callers gate on history_armed) --------

    def sample(self, now: Optional[float] = None) -> bool:
        """Read every tracked reader and append each ring — ONE lock
        round. Decimated: a call within ``min_interval_s`` of the last
        sample returns after one clock read + compare. Returns whether a
        sample was taken."""
        t = self._clock() if now is None else now
        if self._last_sample is not None \
                and t - self._last_sample < self._min_interval:
            return False
        with self._lock:
            if self._last_sample is not None \
                    and t - self._last_sample < self._min_interval:
                return False
            self._last_sample = t
            self.samples += 1
            for s in self._series.values():
                if s.reader is None:
                    continue
                try:
                    if s.kind == "histogram":
                        s.ring.append((t,) + _hist_state(s.reader()))
                    else:
                        s.ring.append((t, float(s.reader())))
                except Exception:   # a torn reader must not kill the loop
                    s.errors += 1
        return True

    # -- window access ------------------------------------------------------

    def _window_locked(self, name: str, window_s: Optional[float]
                       ) -> List[tuple]:
        s = self._series.get(name)
        if s is None or not s.ring:
            return []
        if window_s is None:
            return list(s.ring)
        cut = s.ring[-1][0] - float(window_s)
        return [p for p in s.ring if p[0] >= cut]

    def series(self, name: str, window_s: Optional[float] = None
               ) -> List[tuple]:
        """Raw retained points for ``name`` (newest-last), optionally
        restricted to the trailing window."""
        with self._lock:
            return self._window_locked(name, window_s)

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            s = self._series.get(name)
            if s is None or not s.ring:
                return None
            return s.ring[-1][1]

    def delta(self, name: str, window_s: Optional[float] = None) -> float:
        """newest - oldest value over the window (counters: events seen)."""
        with self._lock:
            pts = self._window_locked(name, window_s)
        if len(pts) < 2:
            return 0.0
        return pts[-1][1] - pts[0][1]

    def rate(self, name: str, window_s: Optional[float] = None) -> float:
        """Windowed events/second for a cumulative counter series."""
        with self._lock:
            pts = self._window_locked(name, window_s)
        if len(pts) < 2:
            return 0.0
        dt = pts[-1][0] - pts[0][0]
        return (pts[-1][1] - pts[0][1]) / dt if dt > 0 else 0.0

    def mean(self, name: str, window_s: Optional[float] = None) -> float:
        with self._lock:
            pts = self._window_locked(name, window_s)
        if not pts:
            return 0.0
        return sum(p[1] for p in pts) / len(pts)

    def slope(self, name: str, window_s: Optional[float] = None) -> float:
        """Least-squares slope (units/second) of a gauge series over the
        window — the queue-depth/burn-rate TREND the autoscaler keys on."""
        with self._lock:
            pts = self._window_locked(name, window_s)
        n = len(pts)
        if n < 2:
            return 0.0
        t0 = pts[0][0]
        mt = sum(p[0] - t0 for p in pts) / n
        mv = sum(p[1] for p in pts) / n
        num = sum((p[0] - t0 - mt) * (p[1] - mv) for p in pts)
        den = sum((p[0] - t0 - mt) ** 2 for p in pts)
        return num / den if den > 0 else 0.0

    def window_quantile(self, name: str, q: float,
                        window_s: Optional[float] = None) -> float:
        """Quantile estimate of the observations RECORDED INSIDE the
        window, from the bucket-count delta between the window's
        endpoint samples (linear interpolation within the straddling
        bucket; the +inf bucket clamps to the last finite bound). This
        is what "p95 TTFT over the last 5 minutes" means against a
        cumulative histogram."""
        with self._lock:
            pts = self._window_locked(name, window_s)
        if len(pts) < 2:
            return 0.0
        _, c0, _, b0, bounds = pts[0]
        _, c1, _, b1, _ = pts[-1]
        if c1 <= c0 or len(b0) != len(b1):
            return 0.0
        dcounts = [n1 - n0 for n0, n1 in zip(b0, b1)]
        total = sum(dcounts)
        if total <= 0:
            return 0.0
        target = max(0.0, min(1.0, q)) * total
        seen = 0.0
        lo = 0.0
        for i, n in enumerate(dcounts):
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            if n > 0 and seen + n >= target:
                if i >= len(bounds):        # +inf bucket: clamp
                    return float(bounds[-1])
                frac = (target - seen) / n
                return float(lo + (hi - lo) * frac)
            seen += n
            lo = hi
        return float(bounds[-1])

    def window_mean(self, name: str,
                    window_s: Optional[float] = None) -> float:
        """Mean of the observations recorded inside the window (sum/count
        deltas of a histogram series)."""
        with self._lock:
            pts = self._window_locked(name, window_s)
        if len(pts) < 2:
            return 0.0
        dc = pts[-1][1] - pts[0][1]
        ds = pts[-1][2] - pts[0][2]
        return ds / dc if dc > 0 else 0.0

    # -- export -------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot_status(self) -> Dict[str, Any]:
        with self._lock:
            return {"armed": history_armed[0], "samples": self.samples,
                    "capacity": self._capacity,
                    "min_interval_s": self._min_interval,
                    "series": {s.name: len(s.ring)
                               for s in self._series.values()}}

    def snapshot(self, window_s: Optional[float] = None
                 ) -> Dict[str, Any]:
        """The ``history.json`` series block: every retained point per
        series (bounded by construction — ring capacity × family count),
        histograms reduced to (t, count, sum) triples."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name in sorted(self._series):
                s = self._series[name]
                pts = self._window_locked(name, window_s)
                if s.kind == "histogram":
                    points = [[round(p[0], 6), p[1], round(p[2], 6)]
                              for p in pts]
                else:
                    points = [[round(p[0], 6), round(p[1], 6)]
                              for p in pts]
                out[name] = {"kind": s.kind, "errors": s.errors,
                             "points": points}
            return out
