"""Profiler with scheduler-windowed capture and its exporters —
counterpart of ``paddle_tpu/profiler/profiler.py``.

The state machine is the reference's: CLOSED → READY (warm-up) → RECORD
→ RECORD_AND_RETURN on the last active step, driven by
``Profiler.step()``; host spans (``RecordEvent``, the dispatcher's op
spans, the DataLoader's) are recorded while a window is open and
exported as chrome tracing with the reference's event fields and file
naming.

The device trace is ``torch.profiler.profile`` with CPU and CUDA
activities over the capture window (the reference starts
``jax.profiler.start_trace``, an xplane trace), for the ``TPU``,
``GPU`` and ``CUSTOM_DEVICE`` targets; it is written as torch's chrome
trace into ``log_dir`` when the window closes. Two stated differences:
the trace is torch's chrome-trace JSON, not an xplane protobuf; and a
device trace that cannot start raises (the reference swallows the error
and records host spans only).
"""

from __future__ import annotations

import json
import os
import time
from enum import Enum
from typing import Callable, List, Optional, Sequence

from .record import HostSpan, RecordEvent, host_recorder


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last record step of a window


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


_DEVICE_TARGETS = (ProfilerTarget.TPU, ProfilerTarget.GPU,
                   ProfilerTarget.CUSTOM_DEVICE)


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """Window scheduler (paddle.profiler.make_scheduler): ``skip_first``
    steps CLOSED, then cycles of closed/ready/record; ``repeat=0``
    cycles forever."""
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("closed/ready must be >=0 and record >= 1")
    cycle = closed + ready + record

    def fn(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return fn


def _default_scheduler(_step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` callback writing the window's host spans as
    chrome://tracing JSON, ``{worker}_time_{ms}.paddle_trace.json``.

    Spans that share a trace id (one serving request or training step,
    ``observability.trace``) carry ``args.trace_id`` and are linked with
    flow events (``ph: s/t/f``) in start order, so a request's queue
    wait → prefill → decode chain is drawn as arrows."""

    def handler(prof: "Profiler") -> None:
        os.makedirs(dir_name, exist_ok=True)
        worker = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{worker}_time_{int(time.time()*1000)}.paddle_trace.json")
        events = []
        by_trace = {}
        for sp in prof.collected_spans:
            ev = {
                "name": sp.name, "cat": sp.event_type, "ph": "X",
                "ts": sp.start_ns / 1000.0,
                "dur": (sp.end_ns - sp.start_ns) / 1000.0,
                "pid": sp.pid, "tid": sp.tid,
            }
            trace_id = getattr(sp, "trace_id", "")
            args = dict(getattr(sp, "args", None) or {})
            if trace_id:
                args.setdefault("trace_id", trace_id)
                by_trace.setdefault(trace_id, []).append(ev)
            if args:
                ev["args"] = args
            events.append(ev)
        for flow_id, (trace_id, chain) in enumerate(sorted(by_trace.items()),
                                                    start=1):
            if len(chain) < 2:
                continue
            chain.sort(key=lambda e: e["ts"])
            for i, ev in enumerate(chain):
                ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
                flow = {"name": f"trace/{trace_id}", "cat": "flow",
                        "ph": ph, "id": flow_id, "ts": ev["ts"],
                        "pid": ev["pid"], "tid": ev["tid"]}
                if ph == "f":
                    flow["bp"] = "e"
                events.append(flow)
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        prof.last_export_path = path

    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """The reference's shim: its protobuf is the device trace in
    ``log_dir``, and the host spans go out as chrome tracing beside it.
    The same here (the device trace is torch's, in ``log_dir``)."""
    return export_chrome_tracing(dir_name, worker_name)


class Profiler:
    """Scheduler-windowed profiler (paddle.profiler.Profiler).

    ``targets`` holding TPU, GPU or CUSTOM_DEVICE turns on the device
    trace (``torch.profiler`` with CPU and CUDA activities) for each
    capture window; host spans are recorded while a window is open.
    After a window with a device trace, ``device_profile`` is its
    ``torch.profiler.profile`` (``key_averages()``, ``events()``) and
    ``device_trace_path`` its chrome trace in ``log_dir``."""

    def __init__(self, *, targets: Optional[Sequence[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready=None, timer_only: bool = False,
                 log_dir: str = "./profiler_log"):
        self.targets = list(targets) if targets else [ProfilerTarget.CPU]
        if callable(scheduler):
            self.scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            # (start, end) step-range shorthand, as in the reference
            lo, hi = scheduler
            self.scheduler = make_scheduler(
                closed=max(lo, 0), ready=0, record=hi - lo, repeat=1)
        elif scheduler is None:
            self.scheduler = _default_scheduler
        else:
            raise TypeError(f"bad scheduler: {scheduler!r}")
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.log_dir = log_dir
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self.collected_spans: List[HostSpan] = []
        self.last_export_path: Optional[str] = None
        self.device_profile = None
        self.device_trace_path: Optional[str] = None
        self._device_trace = None
        self._step_event: Optional[RecordEvent] = None
        self._benchmark = _TimerStats()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.current_state = self.scheduler(self.step_num)
        self._transition(ProfilerState.CLOSED, self.current_state)
        self._begin_step_span()

    def stop(self) -> None:
        self._end_step_span()
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._capture_off(export=True)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None) -> None:
        """Advance one step; drives the window state machine."""
        self._end_step_span()
        self._benchmark.record_step(num_samples)
        prev = self.current_state
        self.step_num += 1
        self.current_state = self.scheduler(self.step_num)
        self._transition(prev, self.current_state)
        self._begin_step_span()

    def __enter__(self) -> "Profiler":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- internals ----------------------------------------------------------

    def _transition(self, prev: ProfilerState, new: ProfilerState) -> None:
        was_rec = prev in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        is_rec = new in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if not was_rec and is_rec:
            self._capture_on()
        elif was_rec and prev == ProfilerState.RECORD_AND_RETURN:
            self._capture_off(export=True)
            if is_rec:  # back-to-back windows
                self._capture_on()
        elif was_rec and not is_rec:
            self._capture_off(export=True)

    def _capture_on(self) -> None:
        if self.timer_only:
            return
        if any(t in _DEVICE_TARGETS for t in self.targets):
            self._device_trace = _start_device_trace()
        host_recorder.clear()
        host_recorder.enabled = True

    def _capture_off(self, export: bool) -> None:
        if self.timer_only:
            return
        host_recorder.enabled = False
        self.collected_spans = host_recorder.drain()
        if self._device_trace is not None:
            prof, self._device_trace = self._device_trace, None
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(
                self.log_dir, f"worker_{os.getpid()}_time_"
                f"{int(time.time()*1000)}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.device_profile = prof
            self.device_trace_path = path
        if export and self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def _begin_step_span(self) -> None:
        if host_recorder.enabled:
            self._step_event = RecordEvent(
                f"ProfileStep#{self.step_num}", "ProfileStep")
            self._step_event.begin()

    def _end_step_span(self) -> None:
        if self._step_event is not None:
            self._step_event.end()
            self._step_event = None

    # -- reporting ----------------------------------------------------------

    def summary(self, sorted_by=None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms") -> str:
        from .statistic import summary as _summary
        return _summary(self.collected_spans, sorted_by=sorted_by,
                        time_unit=time_unit)

    def step_info(self, unit: Optional[str] = None) -> str:
        return self._benchmark.info()


def _start_device_trace():
    """A started ``torch.profiler.profile`` over CPU and CUDA activity.
    Raises when it cannot start: no card, or the profiler refused."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the device trace (a TPU, GPU or CUSTOM_DEVICE target) needs "
            "a CUDA device, and none is available; profile with "
            "targets=[ProfilerTarget.CPU] on the host")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except Exception as e:
        raise RuntimeError(f"the device trace could not start: {e}") from e
    return prof


class _TimerStats:
    """reads/ips bookkeeping behind Profiler.step_info (the reference's
    benchmark() timer)."""

    def __init__(self):
        self.last_t = None
        self.durs: List[float] = []
        self.samples: List[int] = []

    def record_step(self, num_samples: Optional[int]) -> None:
        t = time.perf_counter()
        if self.last_t is not None:
            self.durs.append(t - self.last_t)
            self.samples.append(num_samples or 0)
        self.last_t = t

    def info(self) -> str:
        if not self.durs:
            return "no steps recorded"
        avg = sum(self.durs) / len(self.durs)
        total_samples = sum(self.samples)
        ips = (total_samples / sum(self.durs)) if total_samples else 0.0
        return (f"avg batch_cost: {avg*1000:.3f} ms, ips: {ips:.3f} samples/s")
