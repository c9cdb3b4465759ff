"""Request timelines: span-tree collector + critical-path attribution —
counterpart of ``paddle_tpu/observability/timeline.py``.

The stack already emits rich per-process spans (``profiler.record.
emit_span`` / ``RecordEvent``) stamped with per-request trace ids, but
nothing assembles them: "where did this request's p99 go?" means
grepping a chrome trace by hand. This module closes that loop:

* :class:`SpanCollector` — a bounded in-process sink (same tap
  discipline as the flight recorder: hot paths check the module-level
  ``timeline_armed`` cell, one list index when disarmed) that groups
  every span by ``trace_id`` into per-request records. One trace id is
  minted at the OUTERMOST submit (``FleetRouter.submit`` when a fleet
  fronts the engines, else ``ServingScheduler.submit``) and propagated
  through replica dispatch, scheduler admission, engine
  prefill/decode/speculation rounds and failover resubmission on a
  sibling replica — so a request that dies mid-stream and resumes
  elsewhere is still ONE tree.
* **critical-path attribution** — when a trace's root span arrives
  (``router.request``, or the scheduler's ``*.request``), the
  collector attributes the request's end-to-end latency to *exclusive*
  segments: ``queue_wait``, ``admission``, ``prefill``, ``decode``,
  ``spec_draft`` / ``spec_verify``, ``failover`` (the gap between a
  replica ejection and the sibling resubmission), ``deliver`` (the
  tail between the last engine span and stream close) and ``host``
  (uncovered scheduler/plan time). Attribution is a sweep over the
  root interval where the innermost covering span wins each slice, so
  the segments tile the root exactly: their sum reconciles with the
  measured e2e by construction.
* **slowest-request exemplars** — the worst ``slow_k`` completed
  requests are auto-captured (tree + segments, materialised so ring
  eviction cannot tear them) and served at ``DiagServer /tracez``; the
  scheduler's ``statusz()`` renders the table, and armed flight-
  recorder bundles embed the whole document (``timelines.json``).

Span-name → segment mapping is declared in ``observability/catalog.py``
(``SPANS``) and lint-checked both directions by tpu-lint's
``span-contract`` rule.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

#: the one cell span emitters check before touching the collector
#: (mutable list so callers read a stable module attribute)
timeline_armed = [False]

#: exact span name -> segment category
_EXACT_CATEGORY = {
    "engine.prefill": "prefill",
    "engine.decode_chunk": "decode",
    "engine.spec_draft": "spec_draft",
    "engine.spec_round": "spec_verify",
    "router.failover_gap": "failover",
    "router.migration": "migration",
    "router.dcn_transfer": "dcn_transfer",
}

#: namespaced span suffix (``<metrics namespace>.<suffix>``) -> category
_SUFFIX_CATEGORY = {
    "queue_wait": "queue_wait",
    "admission": "admission",
}

#: every segment key attribution may produce (documented README order)
SEGMENT_KEYS = ("queue_wait", "admission", "prefill", "decode",
                "spec_draft", "spec_verify", "failover", "migration",
                "dcn_transfer", "deliver", "host")


def span_category(name: str) -> Optional[str]:
    """Segment category for a span name, None for container/other spans."""
    cat = _EXACT_CATEGORY.get(name)
    if cat is not None:
        return cat
    return _SUFFIX_CATEGORY.get(name.rsplit(".", 1)[-1])


def is_root_span(name: str) -> bool:
    """Request-envelope spans: the fleet root ``router.request`` or a
    scheduler-level ``<namespace>.request``."""
    return name == "router.request" or name.endswith(".request")


def _span_dict(sp) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "name": sp.name,
        "category": span_category(sp.name),
        "start_us": round(sp.start_ns / 1e3, 1),
        "dur_ms": round((sp.end_ns - sp.start_ns) / 1e6, 4),
    }
    if sp.args:
        d["args"] = dict(sp.args)
    return d


def build_tree(spans) -> List[Dict[str, Any]]:
    """Nest spans by interval containment (outermost first). Returns the
    forest's roots as nested dicts — normally one ``router.request`` /
    ``*.request`` envelope with phase spans inside."""
    nodes = [(sp.start_ns, -sp.end_ns, i, sp) for i, sp in enumerate(spans)]
    nodes.sort(key=lambda t: t[:3])
    roots: List[Dict[str, Any]] = []
    stack: List[tuple] = []          # (end_ns, dict)
    for start, neg_end, _i, sp in nodes:
        end = -neg_end
        node = _span_dict(sp)
        while stack and not (stack[-1][0] >= end
                             and stack[-1][1]["_start"] <= start):
            stack.pop()
        node["_start"] = start
        if stack:
            stack[-1][1].setdefault("children", []).append(node)
        else:
            roots.append(node)
        stack.append((end, node))
    for r in roots:
        _strip_internal(r)
    return roots


def _strip_internal(node: Dict[str, Any]) -> None:
    node.pop("_start", None)
    for c in node.get("children", ()):
        _strip_internal(c)


def attribute_spans(spans, trace_id: str = "") -> Dict[str, Any]:
    """Critical-path attribution for one trace's spans (see module
    docstring). The returned ``segments`` (ms) tile the root interval,
    so ``sum(segments.values()) == e2e_ms``, also after rounding to
    1e-4 ms."""
    roots = [sp for sp in spans if is_root_span(sp.name)]
    fleet = [sp for sp in roots if sp.name == "router.request"]
    pool = fleet or roots or list(spans)
    t0 = min(sp.start_ns for sp in pool)
    t1 = max(sp.end_ns for sp in pool)
    root_name = (fleet or roots or [None])[0]
    intervals = []                   # (start, end, category)
    for sp in spans:
        cat = span_category(sp.name)
        if cat is None:
            continue
        a, b = max(sp.start_ns, t0), min(sp.end_ns, t1)
        if b > a:
            intervals.append((a, b, cat))
    segments = {}
    covered_until = max((b for _, b, _ in intervals), default=t0)
    points = sorted({t0, t1, *(p for a, b, _ in intervals for p in (a, b))})
    for p, q in zip(points, points[1:]):
        if q <= t0 or p >= t1:
            continue
        covering = [iv for iv in intervals if iv[0] <= p and iv[1] >= q]
        if covering:
            # innermost wins: the covering span that started last (ties:
            # the one ending first) owns the slice exclusively
            cat = max(covering, key=lambda iv: (iv[0], -iv[1]))[2]
        elif intervals and p >= covered_until:
            cat = "deliver"          # tail: tokens done, stream closing
        else:
            cat = "host"             # scheduler/plan time between spans
        segments[cat] = segments.get(cat, 0.0) + (q - p)
    # to 1e-4 ms (100 ns ticks), rounding the running sum and not each
    # segment: the rounded segments then add up to the rounded envelope
    # (rounded apart, n segments can miss it by n/2 ticks)
    rounded, cum, tick = {}, 0, 0
    for k, v in sorted(segments.items()):
        cum += v
        prev, tick = tick, round(cum / 100)
        rounded[k] = (tick - prev) / 1e4
    return {
        "trace_id": trace_id,
        "root": getattr(root_name, "name", None),
        "e2e_ms": round((t1 - t0) / 100) / 1e4,
        "segments": rounded,
        "spans": len(spans),
        "complete": bool(roots),
    }


class _Trace:
    __slots__ = ("spans", "complete", "dropped")

    def __init__(self):
        self.spans: List[Any] = []
        self.complete = False
        self.dropped = 0


class SpanCollector:
    """Bounded per-trace span sink (see module docstring). Hot-path
    callers (``profiler.record``) gate on ``timeline_armed[0]`` before
    calling :meth:`note_span`, so the disarmed cost is one list index —
    the same zero-overhead contract as the flight recorder, guarded by
    ``benchmarks/bench_obs_overhead.py``."""

    def __init__(self, max_traces: int = 512,
                 max_spans_per_trace: int = 1024, slow_k: int = 8):
        self._lock = threading.Lock()
        self._max_traces = max_traces
        self._max_spans = max_spans_per_trace
        self._slow_k = slow_k
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        self._completed_fifo: deque = deque()      # eviction order hints
        self._slowest: List[Dict[str, Any]] = []   # desc by e2e_ms
        self._slowest_raw: List[tuple] = []        # unranked (e2e, tid)
        self._raw_tids: set = set()                # O(1) membership twin
        self.dropped_spans = 0
        self.completed = 0

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return timeline_armed[0]

    def arm(self, max_traces: Optional[int] = None,
            max_spans_per_trace: Optional[int] = None,
            slow_k: Optional[int] = None) -> "SpanCollector":
        with self._lock:
            if max_traces is not None:
                self._max_traces = max_traces
            if max_spans_per_trace is not None:
                self._max_spans = max_spans_per_trace
            if slow_k is not None:
                self._slow_k = slow_k
            timeline_armed[0] = True
        return self

    def disarm(self) -> None:
        timeline_armed[0] = False

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._completed_fifo.clear()
            self._slowest = []
            self._slowest_raw = []
            self._raw_tids = set()
            self.dropped_spans = 0
            self.completed = 0

    # -- recording (armed-only; callers gate on timeline_armed[0]) ----------

    def note_span(self, span) -> None:
        """Called by ``profiler.record`` with a ``HostSpan``. Spans with
        no trace id are not per-request and are ignored; a span that is
        neither categorised nor a request root never STARTS a trace
        (scheduler step / dispatch-op spans carry step trace ids and
        would otherwise churn the ring)."""
        if not span.trace_id:
            return
        with self._lock:
            self._note_locked(span)

    def note_spans(self, spans) -> None:
        """Batch variant (``record.emit_spans``): one lock round for an
        engine step's whole span set, with the common case — a
        categorised span landing in a known, unfilled trace — appended
        inline (the serving loop's armed cost, bench_obs_overhead)."""
        with self._lock:
            traces = self._traces
            max_spans = self._max_spans
            for span in spans:
                tid = span.trace_id
                if not tid:
                    continue
                tr = traces.get(tid)
                if (tr is not None and len(tr.spans) < max_spans
                        and not span.name.endswith(".request")):
                    tr.spans.append(span)
                else:
                    self._note_locked(span)

    def _note_locked(self, span) -> None:
        tid = span.trace_id
        root = is_root_span(span.name)
        tr = self._traces.get(tid)
        if tr is None:
            if not root and span_category(span.name) is None:
                return
            tr = self._traces[tid] = _Trace()
            self._evict_locked()
        if len(tr.spans) >= self._max_spans and not root:
            tr.dropped += 1
            self.dropped_spans += 1
            return
        tr.spans.append(span)
        if root:
            # completion: ONE list append on the hot path — ranking,
            # trace-id dedupe, tree + segment attribution all happen
            # lazily at read time (or at ring eviction), never per
            # request in the serving loop (bench_obs_overhead budget)
            if not tr.complete:
                tr.complete = True
                self.completed += 1
                self._completed_fifo.append(tid)
            self._slowest_raw.append(
                ((span.end_ns - span.start_ns) / 1e6, tid))
            self._raw_tids.add(tid)
            if len(self._slowest_raw) >= 256:   # amortised bound
                self._prune_slowest_locked()

    def _prune_slowest_locked(self) -> None:
        """Fold the raw completion feed into the ranked slowest table:
        worst e2e per trace id wins, table trimmed to ``slow_k``.
        Already-materialised entries keep their segments/tree."""
        if not self._slowest_raw:
            return
        raw, self._slowest_raw = self._slowest_raw, []
        self._raw_tids = set()
        by_tid = {e["trace_id"]: e for e in self._slowest}
        for e2e_ms, tid in raw:
            cur = by_tid.get(tid)
            if cur is None or e2e_ms >= cur["e2e_ms"]:
                # a later root (the fleet envelope after replica-level
                # ones) re-ranks the trace; drop stale materialisation
                by_tid[tid] = {"trace_id": tid,
                               "e2e_ms": round(e2e_ms, 4)}
        ranked = sorted(by_tid.values(),
                        key=lambda e: (-e["e2e_ms"], e["trace_id"]))
        self._slowest = ranked[:self._slow_k]

    def _evict_locked(self) -> None:
        while len(self._traces) > self._max_traces:
            victim = None
            while self._completed_fifo:              # oldest complete first
                k = self._completed_fifo.popleft()   # (O(1): lazy hints,
                if k in self._traces:                # stale ids skipped)
                    victim = k
                    break
            if victim is None:
                victim = next(iter(self._traces))    # else plain oldest
            if victim in self._raw_tids:
                # the victim has an unranked completion: fold the raw
                # feed so its exemplar can rank before the spans go.
                # Skipping the prune-sort for the common churn victim
                # (neither raw nor ranked) is real armed-loop savings —
                # steady serving evicts one trace per admission.
                self._prune_slowest_locked()
            for e in self._slowest:
                # about to lose the victim's raw spans: materialise its
                # slowest-table entry first so the exemplar survives
                if e["trace_id"] == victim:
                    self._materialise_locked(e)
            del self._traces[victim]

    def _materialise_locked(self, entry: Dict[str, Any]) -> None:
        """Fill a slowest-table entry's segments + tree from the ring
        (no-op when already materialised or the spans are gone)."""
        if "segments" in entry:
            return
        tr = self._traces.get(entry["trace_id"])
        if tr is None:
            entry["segments"] = {}
            entry["tree"] = []
            return
        timeline = attribute_spans(tr.spans, trace_id=entry["trace_id"])
        timeline["tree"] = build_tree(tr.spans)
        # the lazily-computed e2e (root envelope) supersedes the ranking
        # estimate taken from whichever root span completed last
        entry.update(timeline)

    # -- reading ------------------------------------------------------------

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def spans(self, trace_id: str) -> List[Any]:
        with self._lock:
            tr = self._traces.get(trace_id)
            return list(tr.spans) if tr is not None else []

    def export_new(self, marks: Dict[str, int]) -> List[Any]:
        """Incremental span export for telemetry federation: return
        every span recorded since the caller's last call, where ``marks``
        is the CALLER-owned per-trace watermark dict this method
        advances in place (watermarks of evicted traces are pruned so
        the dict stays bounded by the ring). Spans a trace dropped past
        ``max_spans_per_trace`` — or whole traces evicted between calls
        — are simply absent, the same losses a local reader sees."""
        with self._lock:
            out: List[Any] = []
            for tid, tr in self._traces.items():
                n = marks.get(tid, 0)
                if len(tr.spans) > n:
                    out.extend(tr.spans[n:])
                    marks[tid] = len(tr.spans)
            for tid in list(marks):
                if tid not in self._traces:
                    del marks[tid]
            return out

    def tree(self, trace_id: str) -> List[Dict[str, Any]]:
        """The trace's span forest as nested dicts (normally one root)."""
        return build_tree(self.spans(trace_id))

    def attribute(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Critical-path segments for one trace (None when unknown)."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        return attribute_spans(spans, trace_id=trace_id)

    def slowest(self, n: int = 5, trees: bool = False
                ) -> List[Dict[str, Any]]:
        """Worst completed requests, slowest first: trace id, e2e and
        exclusive segments (plus the span tree when ``trees=True`` —
        the /tracez document). Attribution materialises here, on the
        cold read path, not per completion on the serving hot path."""
        with self._lock:
            self._prune_slowest_locked()
            out = []
            for e in self._slowest[:n]:
                self._materialise_locked(e)
                row = {k: v for k, v in e.items() if k != "tree"}
                if trees:
                    row["tree"] = e.get("tree", [])
                out.append(row)
            return out

    def snapshot_status(self) -> Dict[str, Any]:
        with self._lock:
            self._prune_slowest_locked()
            for e in self._slowest[:5]:
                self._materialise_locked(e)
            return {"armed": timeline_armed[0],
                    "traces": len(self._traces),
                    "completed": self.completed,
                    "dropped_spans": self.dropped_spans,
                    "slowest": [
                        {k: v for k, v in e.items() if k != "tree"}
                        for e in self._slowest[:5]]}

    def tracez(self) -> Dict[str, Any]:
        """The /tracez document: collector status, the slowest-request
        exemplars WITH their span trees, and the span trees of every
        still-active (incomplete) trace — what a postmortem bundle needs
        to be self-contained."""
        with self._lock:
            active = {tid: build_tree(tr.spans)
                      for tid, tr in self._traces.items()
                      if not tr.complete}
        doc = self.snapshot_status()
        doc["slowest"] = self.slowest(self._slow_k, trees=True)
        doc["active"] = active
        return doc


#: the process-global collector the span emitters tap while armed
span_collector = SpanCollector()
