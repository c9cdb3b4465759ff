"""Shared fixed-bucket histogram for metrics sinks —
counterpart of ``paddle_tpu/core/histogram.py``.

Subsystem-neutral home (serving AND the training resilience runtime both
export latency histograms; neither should import the other's metrics
stack for it). ``paddle_tpu_torch.serving.metrics`` re-exports these names, so
existing ``serving.metrics.Histogram`` references keep working.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: default latency bucket upper bounds (milliseconds)
DEFAULT_BOUNDS_MS: Tuple[float, ...] = (
    0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000)

#: default quantiles reported in summaries and the Prometheus dump
DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


class Histogram:
    """Fixed-bucket histogram that also keeps raw samples (ring buffer,
    ``max_samples`` cap) so small/medium runs report *exact* percentiles;
    beyond the cap the ring keeps the most recent window."""

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS_MS,
                 max_samples: int = 65536):
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +inf bucket
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        self._cap = max_samples
        self._sorted: Optional[List[float]] = None   # cache for percentile()

    def record(self, value: float) -> None:
        value = float(value)
        i = 0
        for b in self.bounds:
            if value <= b:
                break
            i += 1
        self.bucket_counts[i] += 1
        if len(self._samples) < self._cap:
            self._samples.append(value)
        else:
            self._samples[self.count % self._cap] = value
        self._sorted = None
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained samples (nearest-rank).
        The sort is cached until the next record() so a multi-quantile
        export costs one sort per histogram, not one per quantile — the
        per-token hot path shares the sink's lock with exports."""
        if not self._samples:
            return 0.0
        ordered = self._sorted
        if ordered is None:   # bind locally: a concurrent record() may
            ordered = self._sorted = sorted(self._samples)  # null the cache
        rank = max(0, min(len(ordered) - 1,
                          int(round(q * (len(ordered) - 1)))))
        return ordered[rank]

    def summary(self, quantiles: Sequence[float] = DEFAULT_QUANTILES
                ) -> Dict[str, float]:
        out = {"count": float(self.count), "sum": self.sum,
               "min": self.min or 0.0, "max": self.max or 0.0,
               "mean": (self.sum / self.count) if self.count else 0.0}
        for q in quantiles:
            out[f"p{int(q * 100)}"] = self.percentile(q)
        return out
