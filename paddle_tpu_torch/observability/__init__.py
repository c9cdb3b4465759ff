"""``paddle_tpu_torch.observability`` — the serving stack's telemetry
(counterpart of ``paddle_tpu/observability``).

Ported, with the JAX package's code and names:

* :mod:`.format`, :mod:`.registry` — ONE process-global
  :class:`MetricsRegistry` (counters, gauges, histograms over
  ``core.histogram``) whose ``prometheus_text()`` is a single valid
  ``/metrics`` document;
* :mod:`.trace` — trace ids propagated through a contextvar;
* :mod:`.events` — the structured JSON-lines event log;
* :mod:`.timeline` — per-request span trees and critical-path segments;
* :mod:`.flight` — the flight recorder and its debug bundles;
* :mod:`.runtime` — recompile detection (the engines' program builds)
  and the dispatch counters;
* :mod:`.journal` — the black-box incident journal and
  ``token_checksum``;
* :mod:`.memory` — the device-memory ledger and capacity planner;
* :mod:`.step_timer`, :mod:`.timeseries`, :mod:`.slo`.

Not yet ported: ``signals``, ``anomaly``, ``profiling``, ``goodput``,
``catalog``, ``server`` (DiagServer), ``replay`` and ``federation``.
"""

from . import format  # noqa: F401
from .events import EventLog, configure_event_log, emit_event, event_log  # noqa: F401
from .flight import FlightRecorder, flight_recorder  # noqa: F401
from .journal import (  # noqa: F401
    JournalError, JournalRecorder, journal, journal_armed, token_checksum,
)
from .memory import (  # noqa: F401
    CapacityPlan, MemoryLedger, memory_ledger, plan_capacity,
    pool_occupancy, pytree_nbytes,
)
from .registry import (  # noqa: F401
    Counter, Gauge, HistogramMetric, MetricsRegistry, get_registry,
)
from .runtime import (  # noqa: F401
    DispatchTelemetry, RecompileDetector, recompiles, telemetry,
)
from .slo import (  # noqa: F401
    SLObjective, SLOMonitor, latency_objective, ratio_objective,
)
from .step_timer import StepTimer  # noqa: F401
from .timeline import SpanCollector, span_collector  # noqa: F401
from .timeseries import MetricHistory  # noqa: F401
from .trace import (  # noqa: F401
    TraceContext, current_trace, current_trace_id, new_trace_id,
    trace_context,
)

__all__ = [
    "Counter", "Gauge", "HistogramMetric", "MetricsRegistry",
    "get_registry", "DispatchTelemetry", "RecompileDetector", "recompiles",
    "telemetry", "StepTimer", "TraceContext", "current_trace",
    "current_trace_id", "new_trace_id", "trace_context", "EventLog",
    "configure_event_log", "emit_event", "event_log", "format",
    "SLObjective", "SLOMonitor", "latency_objective", "ratio_objective",
    "FlightRecorder", "flight_recorder", "SpanCollector", "span_collector",
    "MetricHistory", "CapacityPlan", "MemoryLedger", "memory_ledger",
    "plan_capacity", "pool_occupancy", "pytree_nbytes", "JournalError",
    "JournalRecorder", "journal", "journal_armed", "token_checksum",
]
