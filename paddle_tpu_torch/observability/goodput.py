"""Goodput accounting + straggler detection for training runs —
counterpart of ``paddle_tpu/observability/goodput.py``.

"99% uptime" means little for a training job that spends half its wall
clock replaying steps after rollbacks. **Goodput** is the fraction of
run wall-clock spent making NEW forward progress; everything else is
attributed to a named loss bucket:

==================  ======================================================
bucket              attributed by ``ResilientTrainer``
==================  ======================================================
``productive``      first-time successful step execution
``retry``           failed step attempts + their backoff sleeps
``rollback_replay`` checkpoint restores after NaN/rollback, steps
                    re-executed below the previous high-water mark, and
                    step time wasted on attempts whose loss came back
                    non-finite
``checkpoint_stall``blocking portions of durable saves (sync saves,
                    async-save dispatch, harvest waits)
``restart``         auto-resume restore at run start
``untracked``       loop bookkeeping the trainer does not wrap (computed
                    as ``total - sum(buckets)``, so the breakdown always
                    sums to the run's wall clock exactly)
==================  ======================================================

This module is PURE accounting: callers measure durations with their own
clocks and feed seconds in, so the math is deterministic under fake
clocks (no wall-clock read in ``slo.py`` or ``goodput.py``).

:class:`StragglerDetector` flags per-step timing outliers with a rolling
median/MAD z-score (robust to the heavy tail that makes mean/stddev
useless on step timings); the trainer counts flags into
``paddle_stragglers_total`` and logs a ``straggler`` event carrying the
step and its z-score.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

from .anomaly import robust_zscore
from .registry import get_registry

#: attribution buckets, in reporting order
BUCKETS = ("productive", "retry", "rollback_replay", "checkpoint_stall",
           "restart")


class GoodputTracker:
    """Accumulates seconds into buckets; see module docstring."""

    def __init__(self):
        self._buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.total_s: Optional[float] = None
        self._g_ratio = get_registry().gauge(
            "paddle_goodput_ratio",
            "fraction of run wall-clock spent on new forward progress")

    def note(self, bucket: str, seconds: float) -> None:
        if bucket not in self._buckets:
            raise KeyError(f"unknown goodput bucket {bucket!r}; "
                           f"expected one of {BUCKETS}")
        if seconds > 0:
            self._buckets[bucket] += seconds

    def get(self, bucket: str) -> float:
        return self._buckets[bucket]

    def finalize(self, total_s: float) -> Dict[str, float]:
        """Close the run at ``total_s`` wall seconds and publish the
        goodput gauge. Attribution drift (a bucket measured inside
        another's span) cannot create time: ``untracked`` absorbs the
        exact remainder, clamped at 0."""
        self.total_s = float(total_s)
        return self.breakdown()

    @property
    def goodput_ratio(self) -> float:
        total = self.total_s or sum(self._buckets.values())
        if total <= 0:
            return 0.0
        return min(1.0, self._buckets["productive"] / total)

    def breakdown(self) -> Dict[str, float]:
        total = self.total_s if self.total_s is not None \
            else sum(self._buckets.values())
        out: Dict[str, float] = {"total_s": round(total, 6)}
        for b in BUCKETS:
            out[f"{b}_s"] = round(self._buckets[b], 6)
        out["untracked_s"] = round(
            max(0.0, total - sum(self._buckets.values())), 6)
        out["goodput_ratio"] = round(self.goodput_ratio, 6)
        self._g_ratio.set(out["goodput_ratio"])
        return out


class StragglerDetector:
    """Rolling median/MAD z-score over per-step timings.

    ``observe(seconds)`` returns the robust z-score of the new sample
    against the PREVIOUS window (a straggler must not dilute its own
    baseline); a sample is flagged when ``z > z_threshold`` once at
    least ``min_samples`` are in the window. The math is the shared
    :func:`~paddle_tpu_torch.observability.anomaly.robust_zscore` primitive
    (this class used to keep a private copy; the anomaly plane
    generalised it), including its MAD-of-zero fallback: perfectly
    uniform timings fall back to a fraction of the median so a single
    slow step still flags instead of dividing by zero.
    """

    def __init__(self, window: int = 32, z_threshold: float = 4.0,
                 min_samples: int = 8):
        self.window = window
        self.z_threshold = float(z_threshold)
        self.min_samples = max(2, int(min_samples))
        self._samples: Deque[float] = deque(maxlen=window)
        self.flagged = 0
        self._c_stragglers = get_registry().counter(
            "paddle_stragglers_total",
            "per-step timing outliers (rolling MAD z-score)",
            labels=("source",))

    def zscore(self, value: float) -> float:
        """Robust z of ``value`` against the current window (0 when the
        window is still warming up)."""
        return robust_zscore(value, self._samples, self.min_samples)

    def observe(self, seconds: float, source: str = "train_step") -> float:
        """Score ``seconds`` against the window, THEN admit it; flags
        count into ``paddle_stragglers_total{source=…}``."""
        z = self.zscore(float(seconds))
        if z > self.z_threshold:
            self.flagged += 1
            self._c_stragglers.inc(source=source)
        self._samples.append(float(seconds))
        return z
