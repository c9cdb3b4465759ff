"""Serving metrics: latency histograms, utilization gauges, counters —
counterpart of ``paddle_tpu/serving/metrics.py``.

The serving scheduler records into one :class:`ServingMetrics` sink:

* **TTFT** (time-to-first-token) and **ITL** (inter-token latency)
  histograms per request. Tokens reach the host one decode *chunk* at a
  time (the engine's single fence per round), so ITL shows the chunk
  cadence: the first token of a chunk carries the device round's latency,
  the rest are ~0. That is the true serving profile, not an artifact.
* queue depth, slot and page utilization, sampled once per scheduler step
  (gauge = last value, histogram = distribution over the run).
* counters: submitted/completed/shed (by reason)/cancelled, step retries
  and failures, generated tokens.

Export surfaces:

* :meth:`ServingMetrics.to_prometheus_text` — Prometheus exposition text
  (histogram ``_bucket``/``_sum``/``_count`` plus exact-percentile
  ``_quantile`` gauges as a separate family — mixing quantile samples
  into a histogram family is invalid exposition format) ready for a
  /metrics endpoint or a scrape file.
* trace events — :meth:`ServingMetrics.span` returns a profiler
  ``RecordEvent`` so scheduler phases land in the host-span recorder (and
  in the torch.profiler trace when a profiler capture is active), correlated
  with device activity.

Thread-safe: the scheduler may run ``engine.step`` on a watchdog thread
(step timeouts), so every mutation takes the sink's lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ..core.histogram import (DEFAULT_BOUNDS_MS, DEFAULT_QUANTILES,  # noqa: F401
                              Histogram)
from ..observability import format as _fmt
from ..observability.registry import get_registry
from ..profiler.record import RecordEvent

#: observations per family before a non-record observation may replace
#: the exemplar anyway ("worst RECENT", not worst-ever: a p99 spike from
#: last week must not pin the exemplar forever)
EXEMPLAR_WINDOW = 128


class ServingMetrics:
    """Process-local metrics sink for one :class:`ServingScheduler`.

    Registered into the global :class:`~paddle_tpu_torch.observability.registry.
    MetricsRegistry` under its namespace (a fresh sink replaces the
    previous one — normal per-server lifecycle), so the process-wide
    ``/metrics`` document includes serving without a second scrape."""

    def __init__(self, namespace: str = "paddle_serving"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self.histograms: Dict[str, Histogram] = {
            "ttft_ms": Histogram(),
            "itl_ms": Histogram(),
            "e2e_ms": Histogram(),
            "queue_wait_ms": Histogram(),
            "step_ms": Histogram(),
            "queue_depth": Histogram(bounds=(0, 1, 2, 4, 8, 16, 32, 64,
                                             128, 256)),
        }
        self.counters: Dict[str, float] = {
            "requests_submitted_total": 0,
            "requests_completed_total": 0,
            "requests_cancelled_total": 0,
            "step_retries_total": 0,
            "step_failures_total": 0,
            "steps_total": 0,
            "tokens_generated_total": 0,
        }
        #: shed counts keyed by reason ("queue_full", "deadline", ...)
        self.shed: Dict[str, float] = {}
        #: last-value gauges (utilizations in [0, 1], depths in requests).
        #: EVERY family set_gauge() may touch is declared here — an
        #: undeclared name would be minted on first set and missing from
        #: /metrics until then, so the scrape schema would depend on
        #: which code paths have run (tpu-lint metric-contract)
        self.gauges: Dict[str, float] = {
            "queue_depth": 0.0,
            "slot_utilization": 0.0,
            "page_utilization": 0.0,
            "live_page_utilization": 0.0,
            "cached_page_utilization": 0.0,
            "inflight": 0.0,
            "degraded": 0.0,
            "slo_breached": 0.0,
        }
        #: per-family worst-recent exemplar: hist -> {"trace_id",
        #: "value", "n"} (n = observation count at capture; see
        #: EXEMPLAR_WINDOW). Answers "WHICH request was the p99" —
        #: the trace id keys straight into the span collector / /tracez.
        self._exemplars: Dict[str, Dict] = {}
        self._obs_counts: Dict[str, int] = {}
        get_registry().register_sink(self.namespace, self._prometheus_lines,
                                     self.summary)

    # -- recording ----------------------------------------------------------

    def observe(self, hist: str, value: float,
                trace_id: str = None) -> None:
        """Record into a histogram family; when ``trace_id`` is given the
        observation competes for the family's exemplar slot (kept when it
        is the worst seen, or when the current exemplar is older than
        ``EXEMPLAR_WINDOW`` observations)."""
        with self._lock:
            self.histograms[hist].record(value)
            if trace_id is None:
                return
            n = self._obs_counts.get(hist, 0) + 1
            self._obs_counts[hist] = n
            ex = self._exemplars.get(hist)
            if (ex is None or value >= ex["value"]
                    or n - ex["n"] >= EXEMPLAR_WINDOW):
                self._exemplars[hist] = {"trace_id": trace_id,
                                         "value": float(value), "n": n}

    def inc(self, counter: str, by: float = 1) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + by

    def inc_shed(self, reason: str) -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def set_gauge(self, gauge: str, value: float) -> None:
        with self._lock:
            self.gauges[gauge] = float(value)

    def span(self, name: str, event_type: str = "UserDefined",
             args: Dict[str, object] = None,
             trace_id: str = None, light: bool = False) -> RecordEvent:
        """A profiler span (``with metrics.span('serving.step'): ...``);
        shows up in the host recorder / torch.profiler trace under
        ``<namespace>.<name>``. ``args``/``trace_id`` flow into the
        chrome-trace event (trace_id=None picks up the ambient trace
        context). ``light=True`` records only inside a profiler capture
        window (see :class:`~paddle_tpu_torch.profiler.record.RecordEvent`) —
        for per-step spans whose flight-ring copies would be pure
        armed-loop cost."""
        return RecordEvent(f"{self.namespace}.{name}", event_type,
                           args=args, trace_id=trace_id, light=light)

    def mark(self, name: str) -> None:
        """Zero-length trace event (shed/cancel/retry markers)."""
        ev = self.span(name)
        ev.begin()
        ev.end()

    # -- export -------------------------------------------------------------

    @property
    def shed_total(self) -> float:
        with self._lock:
            return sum(self.shed.values())

    def exemplars_snapshot(self) -> Dict[str, Dict]:
        """{family: {"trace_id", "value"}} for the worst recent TTFT/ITL/
        e2e/queue-wait observations (exposed on /statusz; the exposition
        text stays exemplar-free — Prometheus 0.0.4 has no exemplar
        syntax and the line validator would reject a nonstandard one)."""
        with self._lock:
            return {k: {"trace_id": v["trace_id"], "value": v["value"]}
                    for k, v in sorted(self._exemplars.items())}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Nested dict summary (histogram percentiles + counters + gauges)."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {
                name: h.summary() for name, h in self.histograms.items()}
            out["counters"] = dict(self.counters)
            out["counters"]["requests_shed_total"] = sum(self.shed.values())
            for reason, n in self.shed.items():
                out["counters"][f"requests_shed_total[{reason}]"] = n
            out["gauges"] = dict(self.gauges)
            if self._exemplars:
                out["exemplars"] = {
                    k: {"trace_id": v["trace_id"], "value": v["value"]}
                    for k, v in sorted(self._exemplars.items())}
        return out

    def _prometheus_lines(self) -> List[str]:
        """Exposition lines (assembled by ``observability.format``, the
        single formatter): every histogram as buckets/sum/count plus a
        sibling ``<name>_quantile`` gauge family with exact percentiles,
        counters as ``_total``, gauges as plain gauges."""
        ns = self.namespace
        lines: List[str] = []
        with self._lock:
            for name, h in self.histograms.items():
                lines.extend(_fmt.histogram_lines(
                    f"{ns}_{name}", h,
                    help=f"serving {name} distribution",
                    quantiles=DEFAULT_QUANTILES))
            for name, v in self.counters.items():
                lines.extend(_fmt.counter_lines(f"{ns}_{name}", value=v))
            # labeled per-reason series only: an unlabeled grand-total
            # sibling would double-count sum() queries over the family
            lines.extend(_fmt.counter_lines(
                f"{ns}_requests_shed_total",
                series=[({"reason": r}, n)
                        for r, n in sorted(self.shed.items())]))
            for name, v in self.gauges.items():
                lines.extend(_fmt.gauge_lines(f"{ns}_{name}_gauge", value=v))
        return lines

    def to_prometheus_text(self) -> str:
        """This sink alone as Prometheus exposition text (the registry's
        ``prometheus_text()`` gives the whole process)."""
        return "\n".join(self._prometheus_lines()) + "\n"
