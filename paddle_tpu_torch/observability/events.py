"""Structured JSON-lines event log with size-capped rotation —
counterpart of ``paddle_tpu/observability/events.py``.

One sink shared by serving and resilience (and the recompile detector):
shed / retry / rollback / preempt / recompile events land here as one
JSON object per line, so an operator can ``jq`` a production incident
without correlating three ad-hoc log formats.

Disabled (no-op, one ``is None`` check per emit) until
:func:`configure_event_log` points it at a path. Rotation keeps
``backups`` closed generations (``events.jsonl.1`` newest … ``.N``
oldest) and never lets the live file exceed ``max_bytes``.

``emit`` is called from scheduler/trainer hot paths, so it is
exception-safe by contract: an I/O failure (full disk, a path turned
into a directory, a racing rotation) increments
``paddle_events_dropped_total`` and drops the event instead of
propagating into the step loop. While the flight recorder is armed,
every record also lands in its ring — even when the file sink is
disabled.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .flight import flight_armed, flight_recorder
from .trace import current_trace

_dropped_counter = None       # lazy: created on first drop, then cached


def _count_dropped() -> None:
    global _dropped_counter
    try:
        if _dropped_counter is None:
            from .registry import get_registry
            _dropped_counter = get_registry().counter(
                "paddle_events_dropped_total",
                "events lost to event-log I/O failures")
        _dropped_counter.inc()
    except Exception:         # even the accounting must never propagate
        pass


class EventLog:
    def __init__(self, path: Optional[str] = None,
                 max_bytes: int = 1 << 20, backups: int = 2):
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        self._max_bytes = max_bytes
        self._backups = backups
        self._size = 0
        if path is not None:
            self.configure(path, max_bytes=max_bytes, backups=backups)

    @property
    def enabled(self) -> bool:
        return self._path is not None

    @property
    def path(self) -> Optional[str]:
        return self._path

    def configure(self, path: Optional[str], max_bytes: int = 1 << 20,
                  backups: int = 2) -> "EventLog":
        """Point the sink at ``path`` (None disables it again)."""
        with self._lock:
            self._path = path
            self._max_bytes = max_bytes
            self._backups = backups
            if path is not None:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._size = (os.path.getsize(path)
                              if os.path.exists(path) else 0)
        return self

    def emit(self, kind: str, **fields) -> None:
        """Append one event (see module docstring: exception-safe, taps
        the armed flight recorder). The current trace context's ids are
        attached automatically (explicit kwargs win)."""
        if self._path is None and not flight_armed[0]:
            return
        ctx = current_trace()
        record = {"ts": round(time.time(), 6), "kind": kind}
        if ctx is not None:
            record["trace_id"] = ctx.trace_id
            if ctx.request_id is not None:
                record.setdefault("request_id", ctx.request_id)
            if ctx.step is not None:
                record.setdefault("step", ctx.step)
        record.update(fields)
        if flight_armed[0]:
            flight_recorder.note_event(record)
        if self._path is None:
            return
        try:
            line = json.dumps(record, default=str,
                              separators=(",", ":")) + "\n"
            data = line.encode()
            with self._lock:
                if self._path is None:
                    return
                if self._size and self._size + len(data) > self._max_bytes:
                    self._rotate_locked()
                with open(self._path, "ab") as f:
                    f.write(data)
                self._size += len(data)
        except Exception:
            # full disk / rotation race / unserialisable field: the hot
            # path (scheduler, trainer) must never see event-log errors
            _count_dropped()

    def _rotate_locked(self) -> None:
        """path -> path.1 -> … -> path.backups (oldest dropped). Caller
        holds ``self._lock`` (the ``_locked`` suffix is the repo-wide
        lock-discipline convention, see tpu-lint lock-unguarded-write)."""
        if self._backups <= 0:
            try:
                os.remove(self._path)
            except OSError:
                pass
        else:
            oldest = f"{self._path}.{self._backups}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self._backups - 1, 0, -1):
                src = f"{self._path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self._path}.{i + 1}")
            if os.path.exists(self._path):
                os.replace(self._path, f"{self._path}.1")
        self._size = 0


#: the process-global sink serving/resilience/runtime emit into
event_log = EventLog()


def configure_event_log(path: Optional[str], max_bytes: int = 1 << 20,
                        backups: int = 2) -> EventLog:
    return event_log.configure(path, max_bytes=max_bytes, backups=backups)


def emit_event(kind: str, **fields) -> None:
    event_log.emit(kind, **fields)
