"""Process-local metrics of the fault-tolerant training runtime —
counterpart of ``paddle_tpu/resilience/metrics.py``: counters (restores,
corrupt checkpoints skipped, step retries, NaN rollbacks, skipped steps,
preemptions and their flushes, save failures) and a save-latency
histogram, as a ``summary()`` dict and as Prometheus text. The sink
registers into the process-wide ``MetricsRegistry`` (a re-created sink
replaces its namespace), so ``/metrics`` carries resilience beside
serving and runtime telemetry."""

from __future__ import annotations

from typing import Dict, List

from ..core.histogram import Histogram
from ..observability import format as _fmt
from ..observability.registry import get_registry


class ResilienceMetrics:
    def __init__(self, namespace: str = "paddle_resilience"):
        self.namespace = namespace
        self.counters: Dict[str, float] = {}
        self.save_latency_ms = Histogram()
        get_registry().register_sink(self.namespace, self._prometheus_lines,
                                     self.summary)

    def inc(self, counter: str, by: float = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0.0) + by

    def get(self, counter: str) -> float:
        return self.counters.get(counter, 0.0)

    def observe_save_ms(self, value_ms: float) -> None:
        self.save_latency_ms.record(value_ms)
        self.inc("saves")

    def summary(self) -> Dict[str, object]:
        return {"counters": dict(self.counters),
                "save_latency_ms": self.save_latency_ms.summary()}

    def _prometheus_lines(self) -> List[str]:
        ns = self.namespace
        lines: List[str] = []
        for name in sorted(self.counters):
            lines.extend(_fmt.counter_lines(f"{ns}_{name}_total",
                                            value=self.counters[name]))
        lines.extend(_fmt.histogram_lines(f"{ns}_save_latency_ms",
                                          self.save_latency_ms))
        return lines

    def to_prometheus_text(self) -> str:
        return "\n".join(self._prometheus_lines()) + "\n"
