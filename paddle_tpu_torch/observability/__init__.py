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
* :mod:`.step_timer`, :mod:`.timeseries`, :mod:`.slo`;
* :mod:`.anomaly` — median/MAD z-score and CUSUM detectors behind the
  cooldown'd :class:`AnomalyMonitor`;
* :mod:`.goodput` — goodput buckets and the straggler detector;
* :mod:`.signals` — the :class:`SignalBus` sensor plane (``/varz``);
* :mod:`.catalog` — every registry family, event kind and span name;
* :mod:`.server` — the stdlib :class:`DiagServer` (``/metrics``,
  ``/healthz``, ``/statusz``, ``/tracez``, ``/varz``, ``/scalez``,
  ``/journalz``, ``/memz``, ``/debugz``);
* :mod:`.replay` — postmortem replay of a bundle's journal
  (``python -m paddle_tpu_torch.observability.replay <bundle>``);
* :mod:`.federation` — fleet-wide telemetry federation: per-host
  mirrors fed by the engine processes' heartbeats, clock-offset
  estimation, one merged ``/metrics`` document;
* :mod:`.profiling` — hot producer→consumer dispatch chains from the
  dispatcher's and the serving engine's taps, exported as a stable JSON
  artifact.
"""

from . import format  # noqa: F401
from .anomaly import (  # noqa: F401
    AnomalyMonitor, CusumDetector, RobustZScoreDetector, robust_zscore,
)
from .events import EventLog, configure_event_log, emit_event, event_log  # noqa: F401
from .federation import (  # noqa: F401
    ClockSync, FederationHub, HostTelemetryMirror, collect_telemetry,
    federation_armed, merge_expositions,
)
from .flight import FlightRecorder, flight_recorder  # noqa: F401
from .goodput import GoodputTracker, StragglerDetector  # noqa: F401
from .profiling import (  # noqa: F401
    DispatchChainProfiler, chain_armed, chain_profiler, note_chain,
)
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
from .server import DiagServer  # noqa: F401
from .signals import (  # noqa: F401
    SIGNAL_SNAPSHOT_VERSION, SignalBus, SignalSnapshot,
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
    "GoodputTracker", "StragglerDetector", "DiagServer", "SignalBus",
    "SignalSnapshot", "SIGNAL_SNAPSHOT_VERSION", "AnomalyMonitor",
    "RobustZScoreDetector", "CusumDetector", "robust_zscore",
    "ClockSync", "FederationHub", "HostTelemetryMirror",
    "collect_telemetry", "federation_armed", "merge_expositions",
    "DispatchChainProfiler", "chain_armed", "chain_profiler", "note_chain",
    "ReplayClock", "ReplayRefused", "ReplayReport", "replay_bundle",
    "replay_journal",
]

_REPLAY = ("ReplayClock", "ReplayRefused", "ReplayReport", "replay_bundle",
           "replay_journal")


def __getattr__(name):
    # the replay names load on first use, so ``python -m
    # paddle_tpu_torch.observability.replay`` runs a module the package
    # has not imported yet
    if name in _REPLAY:
        from . import replay
        return getattr(replay, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
