"""Trace-context propagation: one id per serving request / training step —
counterpart of ``paddle_tpu/observability/trace.py``.

A :class:`TraceContext` rides a ``contextvars.ContextVar``, so it flows
scheduler → engine step → ``core.dispatch.apply`` RecordEvent spans
without threading ids through every call signature, and survives the
serving watchdog thread (``contextvars`` copy into ``threading.Thread``
targets started inside the context... they do NOT automatically — the
scheduler passes the context explicitly where it matters).

Ids are deterministic (pid + monotonic counter, no wall clock / RNG) so
chaos-replay runs produce identical traces.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional

_ctx: contextvars.ContextVar[Optional["TraceContext"]] = \
    contextvars.ContextVar("paddle_tpu_trace", default=None)
_counter = itertools.count(1)
_counter_lock = threading.Lock()


@dataclass(frozen=True)
class TraceContext:
    """Immutable trace identity: ``trace_id`` correlates spans, the
    optional ``request_id``/``step`` say what the trace is about."""

    trace_id: str
    request_id: Optional[int] = None
    step: Optional[int] = None


def new_trace_id(prefix: str = "t") -> str:
    with _counter_lock:
        n = next(_counter)
    return f"{prefix}-{os.getpid():x}-{n:x}"


def current_trace() -> Optional[TraceContext]:
    return _ctx.get()


def current_trace_id() -> str:
    ctx = _ctx.get()
    return ctx.trace_id if ctx is not None else ""


@contextmanager
def trace_context(trace_id: Optional[str] = None,
                  request_id: Optional[int] = None,
                  step: Optional[int] = None) -> Iterator[TraceContext]:
    """Enter a trace context (minting an id when none is given); restores
    the previous context on exit, so nesting works."""
    ctx = TraceContext(trace_id or new_trace_id(),
                       request_id=request_id, step=step)
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)
