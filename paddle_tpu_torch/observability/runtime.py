"""Always-on, low-overhead runtime telemetry for the op dispatcher —
counterpart of ``paddle_tpu/observability/runtime.py``.

In the JAX package ``core.dispatch.apply`` is the single funnel every
eager op goes through, and this module gives it the counters below. The
port's eager API has no such funnel yet (it comes with the rest of the
eager API), so the dispatch counters count what a caller hands them; the
recompile detector counts the serving engines' program builds (a CUDA
graph capture on the card, as the JAX engine's jit compile):

* per-op dispatch **counters** (``paddle_runtime_op_dispatch_total{op=…}``)
  and **sampled durations** (1 in ``sample_every`` dispatches per op lands
  in ``paddle_runtime_op_duration_us``) — cheap enough to leave on in
  production;
* **recompile detection**: every compile-cache miss (the engines'
  program builds) increments
  ``paddle_runtime_recompiles_total{fn=…}`` exactly once per new shape
  signature and logs a structured event carrying the shapes, so a shape
  leak that silently retraces per step becomes a counter you can alert on;
* the **single-boolean fast path**: ``dispatch_armed[0]`` is the ONE flag
  ``apply`` checks per dispatch. It is recomputed only when telemetry is
  switched or a profiler capture window opens/closes, so a fully disarmed
  dispatcher pays one list-index — the zero-overhead contract guarded by
  ``benchmarks/bench_dispatch_overhead.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .events import emit_event
from .registry import get_registry

#: the one flag core.dispatch.apply checks per call (mutable cell so the
#: dispatcher reads a stable module attribute, not a rebindable name)
dispatch_armed = [False]

_capture_active = False     # mirrors profiler.record.host_recorder.enabled


def _rearm() -> None:
    dispatch_armed[0] = _capture_active or telemetry.enabled


def set_capture_active(active: bool) -> None:
    """Called by the profiler's host recorder when a capture window opens
    or closes (keeps the fast-path flag a single check)."""
    global _capture_active
    _capture_active = bool(active)
    _rearm()


class DispatchTelemetry:
    """Per-op dispatch counters + sampled duration histogram. ON by
    default (the always-on view); ``disable()`` restores the seed-exact
    fast path."""

    def __init__(self, sample_every: int = 64):
        self.sample_every = sample_every
        self._enabled = True
        self._counts: Dict[str, int] = {}
        reg = get_registry()
        self._duration_us = reg.histogram(
            "paddle_runtime_op_duration_us",
            "sampled eager-dispatch wall time per op (µs)",
            bounds=(1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 100000))

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True
        _rearm()

    def disable(self) -> None:
        self._enabled = False
        _rearm()

    def count(self, op_name: str) -> bool:
        """Hot path: bump the dispatch counter; True when this dispatch
        should have its duration sampled (1 in ``sample_every`` per op).
        GIL-serialized dict ops — a lost count under free threading is
        acceptable for telemetry."""
        c = self._counts
        n = c.get(op_name, 0)
        c[op_name] = n + 1
        return n % self.sample_every == 0

    def observe_duration(self, dur_ns: int) -> None:
        self._duration_us.observe(dur_ns / 1e3)

    @property
    def op_counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def reset(self) -> None:
        self._counts.clear()

    # -- export (registered as a registry sink) -----------------------------

    def _lines(self):
        from . import format as fmt
        series = [({"op": op}, float(n))
                  for op, n in sorted(self._counts.items())]
        if not series:
            return []
        return fmt.counter_lines(
            "paddle_runtime_op_dispatch_total", series=series,
            help="eager op dispatches through core.dispatch.apply")

    def _snapshot(self):
        return {"op_dispatch_total": dict(self._counts)}


class RecompileDetector:
    """Counts compile-cache misses once per (fn, shape-signature)."""

    def __init__(self):
        self._seen: Dict[str, set] = {}
        self._lock = threading.Lock()
        reg = get_registry()
        self._counter = reg.counter(
            "paddle_runtime_recompiles_total",
            "program builds (first build included), by function",
            labels=("fn",))
        self._compile_s = reg.histogram(
            "paddle_runtime_compile_seconds",
            "wall time of a new program's first call (build and capture) per cache miss, by function",
            labels=("fn",),
            bounds=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
                    30.0, 60.0, 120.0))
        self._compile_sums: Dict[str, float] = {}

    def note(self, fn_name: str, shape_key) -> bool:
        """Record a compile-cache lookup for ``fn_name`` with hashable
        ``shape_key``. Returns True (and counts + logs an event) only the
        first time this (fn, key) is seen — for callers WITHOUT their own
        per-instance compile cache. Callers that already deduplicate
        (engines, CompileGuard) use :meth:`record_miss` instead, or a
        second instance's real recompiles would be swallowed here."""
        key = shape_key if isinstance(shape_key, tuple) else (shape_key,)
        with self._lock:
            seen = self._seen.setdefault(fn_name, set())
            if key in seen:
                return False
            seen.add(key)
            distinct = len(seen)
        self._fire(fn_name, shape_key, distinct)
        return True

    def record_miss(self, fn_name: str, shape_key) -> None:
        """Unconditionally count one trace-cache miss — for callers whose
        OWN compile cache already deduplicates shapes (the decoding
        engines check ``key not in self._compiled`` before calling); a
        fresh engine's first compile is a real miss even if another
        instance compiled the same shapes earlier."""
        self._fire(fn_name, shape_key, None)

    def _fire(self, fn_name: str, shape_key, distinct) -> None:
        self._counter.inc(fn=fn_name)
        extra = {} if distinct is None else {"distinct_signatures": distinct}
        emit_event("recompile", fn=fn_name, shapes=repr(shape_key), **extra)

    def observe_compile(self, fn_name: str, seconds: float) -> None:
        """Record one compile's wall time (the caller times its first
        invocation of a freshly built program, blocked to completion) so
        warmup cost shows up in ``paddle_runtime_compile_seconds{fn}``
        on /metrics and in bench JSON lines."""
        self._compile_s.observe(float(seconds), fn=fn_name)
        with self._lock:
            self._compile_sums[fn_name] = (
                self._compile_sums.get(fn_name, 0.0) + float(seconds))

    def compile_seconds_total(self, fn_name: str) -> float:
        """Summed compile wall time recorded for ``fn_name`` (local
        mirror — reading an unseen fn must NOT materialize an empty
        labeled series on /metrics)."""
        with self._lock:
            return self._compile_sums.get(fn_name, 0.0)

    def count(self, fn_name: Optional[str] = None) -> float:
        if fn_name is not None:
            return self._counter.value(fn=fn_name)
        return self._counter.total

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()


telemetry = DispatchTelemetry()
recompiles = RecompileDetector()
get_registry().register_sink("paddle_runtime_ops", telemetry._lines,
                             telemetry._snapshot)
_rearm()
