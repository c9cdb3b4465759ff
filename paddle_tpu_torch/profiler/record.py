"""Host span recorder + RecordEvent annotation API —
counterpart of ``paddle_tpu/profiler/record.py``.

Reference: RecordEvent (python/paddle/profiler/utils.py) backed by the C++
thread-local HostEventRecorder (paddle/fluid/platform/profiler/
host_tracer.cc — SURVEY.md §5.1). Here the recorder is a process-global,
thread-aware span list; when a capture is active each span additionally
enters a ``torch.profiler.record_function`` range so it shows up in the
torch.profiler trace correlated with device activity (the JAX package
enters a ``jax.profiler.TraceAnnotation`` there).

Spans carry the ambient trace id (``observability.trace``) so one serving
request / training step can be followed across scheduler, engine and op
dispatch in the chrome-tracing export. Outside a capture window,
``RecordEvent.__enter__``/``__exit__`` short-circuit on a single boolean
— the zero-overhead contract the dispatcher relies on.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

from ..observability import runtime as _obs_runtime
from ..observability.flight import flight_armed, flight_recorder
from ..observability.timeline import span_collector, timeline_armed
from ..observability.trace import current_trace


class HostSpan(NamedTuple):
    name: str
    event_type: str
    start_ns: int
    end_ns: int
    tid: int
    pid: int
    trace_id: str = ""
    args: Optional[dict] = None


class _HostRecorder:
    """HostEventRecorder equivalent: lock-guarded span sink, armed only
    while a Profiler capture window is active (zero overhead otherwise).
    Toggling ``enabled`` also re-arms the dispatcher's single-boolean
    fast-path flag (observability.runtime.dispatch_armed)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: List[HostSpan] = []
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._enabled = bool(value)
        _obs_runtime.set_capture_active(self._enabled)

    def emit(self, span: HostSpan) -> None:
        with self._lock:
            self._spans.append(span)

    def drain(self) -> List[HostSpan]:
        with self._lock:
            spans, self._spans = self._spans, []
        return spans

    def clear(self) -> None:
        self.drain()


host_recorder = _HostRecorder()

_MAIN_PID = threading.main_thread().ident or 0


def spans_armed() -> bool:
    """True when ANY span sink wants spans: a profiler capture window,
    the flight recorder's ring, or the timeline span collector. Hot
    call sites (engine step loops, scheduler admission) gate their span
    bookkeeping on this so the disarmed cost stays one boolean + two
    list indexes."""
    return host_recorder.enabled or flight_armed[0] or timeline_armed[0]


def make_span(name: str, start_ns: int, end_ns: int,
              event_type: str = "UserDefined", trace_id: str = "",
              args: Optional[dict] = None) -> HostSpan:
    """Build a HostSpan without emitting it — for hot loops that batch
    several per-request spans into one :func:`emit_spans` call (one lock
    round per sink instead of one per span)."""
    return HostSpan(name, event_type, start_ns, end_ns,
                    threading.get_ident(), _MAIN_PID, trace_id, args)


def emit_spans(spans) -> None:
    """Batch-emit pre-built spans (see :func:`make_span`). Callers gate
    on :func:`spans_armed` before building the batch."""
    if not spans:
        return
    if host_recorder.enabled:
        for sp in spans:
            host_recorder.emit(sp)
    if flight_armed[0]:
        flight_recorder.note_spans(spans)
    if timeline_armed[0]:
        span_collector.note_spans(spans)


def emit_span(name: str, start_ns: int, end_ns: int,
              event_type: str = "UserDefined",
              trace_id: Optional[str] = None,
              args: Optional[dict] = None) -> None:
    """Emit a span with explicit timestamps (for retroactive spans like a
    request's queue wait, whose start predates the emit site). No-op when
    no capture window, flight recorder or span collector is armed.
    ``trace_id=None`` picks up the ambient trace context."""
    if not spans_armed():
        return
    if trace_id is None:
        ctx = current_trace()
        trace_id = ctx.trace_id if ctx is not None else ""
    span = HostSpan(name, event_type, start_ns, end_ns,
                    threading.get_ident(), _MAIN_PID, trace_id, args)
    if host_recorder.enabled:
        host_recorder.emit(span)
    if flight_armed[0]:
        flight_recorder.note_span(span)
    if timeline_armed[0]:
        span_collector.note_span(span)


class RecordEvent:
    """User annotation span (parity: paddle.profiler.RecordEvent).

    Usable as a context manager or via explicit begin()/end(). Event types
    mirror the reference's TracerEventType names (UserDefined, Operator,
    Dataloader, Communication, Forward, Backward, Optimization...).
    ``args`` lands in the chrome-trace event's ``args`` (request ids etc);
    ``trace_id`` overrides the ambient trace context.
    """

    __slots__ = ("name", "event_type", "args", "_trace_id", "_tid0",
                 "_start_ns", "_prof_range", "_is_request", "_light")

    def __init__(self, name: str, event_type: str = "UserDefined",
                 args: Optional[dict] = None,
                 trace_id: Optional[str] = None, light: bool = False):
        self.name = name
        self.event_type = event_type
        self.args = args
        self._trace_id = trace_id
        self._tid0 = trace_id       # constructor value, restored on end()
        # so a REUSED event re-resolves the ambient trace context per
        # begin instead of pinning the first span's id forever
        self._start_ns: Optional[int] = None
        self._prof_range = None
        # precomputed: the timeline collector only consumes request
        # envelopes (every other categorised span arrives via emit_span)
        self._is_request = name.endswith(".request")
        # light spans record ONLY inside a profiler capture window: the
        # per-STEP scheduler span fires hundreds of times a second and
        # would otherwise pay the full HostSpan+ring cost on every armed
        # serving step just to wrap the 256-deep flight ring in under a
        # second (armed-overhead engineering, like the engine's
        # coalesced per-slot windows — bench_obs_overhead)
        self._light = light

    def begin(self) -> None:
        capture = host_recorder._enabled
        # zero-overhead fast path; the timeline term only arms request
        # envelopes — with just the collector armed, step/mark spans
        # nobody would consume never pay the span bookkeeping
        if not capture and (self._light or (
                not flight_armed[0]
                and not (timeline_armed[0] and self._is_request))):
            return
        if self._trace_id is None:
            ctx = current_trace()
            self._trace_id = ctx.trace_id if ctx is not None else ""
        self._start_ns = time.perf_counter_ns()
        if not capture:      # flight-only: skip the profiler range (the
            return           # profiler trace belongs to capture windows)
        try:
            self._prof_range = torch.profiler.record_function(self.name)
            self._prof_range.__enter__()
        except Exception:
            self._prof_range = None

    def end(self) -> None:
        if self._start_ns is None:        # never began (or capture was off)
            return
        if self._prof_range is not None:
            try:
                self._prof_range.__exit__(None, None, None)
            finally:
                self._prof_range = None
        # light spans feed ONLY the capture window — a light span begun
        # under capture with the flight recorder also armed must still
        # stay out of the ring (it would wrap the 256-deep postmortem
        # ring in under a second)
        light = self._light
        if host_recorder._enabled or (not light and (
                flight_armed[0]
                or (timeline_armed[0] and self._is_request))):
            span = HostSpan(
                self.name, self.event_type, self._start_ns,
                time.perf_counter_ns(),
                threading.get_ident(), _MAIN_PID,
                self._trace_id or "", self.args)
            if host_recorder._enabled:
                host_recorder.emit(span)
            if flight_armed[0] and not light:
                flight_recorder.note_span(span)
            if not light and timeline_armed[0] and self._is_request:
                # the ONLY RecordEvent the timeline consumes is the
                # request envelope — step spans and markers carry step
                # trace ids the collector would discard anyway, and the
                # per-step call into it is real armed-loop cost
                # (bench_obs_overhead)
                span_collector.note_span(span)
        self._start_ns = None
        self._trace_id = self._tid0

    def __enter__(self) -> "RecordEvent":
        self.begin()
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


def record_function(name: str, event_type: str = "UserDefined"):
    """Decorator form of RecordEvent."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(name, event_type):
                return fn(*args, **kwargs)
        return wrapper

    return deco
