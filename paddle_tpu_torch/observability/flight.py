"""Flight recorder: last-N telemetry in memory, tarball on demand —
counterpart of ``paddle_tpu/observability/flight.py``.

A production incident needs the moments BEFORE the failure — the events,
spans and metric deltas that a rotating log or a sampled scrape already
dropped. The :class:`FlightRecorder` keeps bounded rings of the most
recent activity and can serialise a *postmortem bundle* at any time:

* ``events`` — every structured event (``emit_event``) while armed, even
  when the JSONL file sink is disabled;
* ``spans`` — profiler ``RecordEvent``/``emit_span`` spans while armed
  (no Profiler capture window required: ``profiler.record`` taps spans
  into the ring whenever ``flight_armed[0]`` is set);
* ``metrics`` — periodic deltas pushed by the SLO monitor (burn rates
  per tick).

Disarmed cost is the zero-overhead contract of the telemetry layer: call
sites check the module-level ``flight_armed`` cell (one list index, no
allocation) exactly like ``runtime.dispatch_armed`` — guarded by
``benchmarks/bench_obs_overhead.py``.

:meth:`FlightRecorder.dump_debug_bundle` writes a tar.gz containing
``metrics.prom`` (the full registry exposition), ``metrics.json`` (its
snapshot), ``events.jsonl`` (ring), ``trace.json`` (ring spans as a
chrome trace that loads in Perfetto), ``slo.json`` (objective states, if
a monitor was attached), ``fleet.json`` (the router's /statusz fleet
view, when a :meth:`attach_router` fleet fronts the engines),
``timelines.json`` (slowest-request span trees + segment attributions
and every active trace, when the timeline collector is armed or a
router is attached), ``history.json`` (the sensor plane's metric
time-series window, smoothed signals and emitted anomalies, when a
:meth:`attach_signals` SignalBus exists), ``memory.json`` (the HBM
memory ledger's class bytes + peaks, per-pool planner verdicts,
per-request page holders and last OOM, when ``observability.memory`` is
armed — an ``oom_<source>`` auto-dump IS the allocation-failure
postmortem) and ``manifest.json`` (reason, counts, config).
:meth:`auto_dump` is the hook the runtime calls on watchdog timeouts,
NaN rollbacks and scheduler degradation — it rate-limits to one bundle
per reason so a crash loop cannot fill the disk.

Bundle schema hygiene: every JSON-object member carries a
top-level ``schema_version`` and the manifest maps EVERY member to its
declared version (``schema_versions``) — list/JSONL members
(``slo.json``, ``events.jsonl``, ``journal.jsonl``) are versioned
through the manifest alone, since injecting keys/header lines would
break their consumers. :func:`validate_bundle` is the one shared
structural validator (postmortem replay refuses through it); when the
black-box journal is armed, its versioned frame ring is embedded as
``journal.jsonl`` and ``python -m paddle_tpu_torch.observability.replay``
can re-execute the bundle.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

#: the one cell hot paths check before touching the recorder (mutable
#: list so callers read a stable module attribute, not a rebindable name)
flight_armed = [False]

#: declared schema version per bundle member; the manifest's
#: ``schema_versions`` map and :func:`validate_bundle` enforce these.
#: Bump a member's entry when its shape changes incompatibly.
BUNDLE_SCHEMAS = {
    "metrics.prom": 1, "metrics.json": 1, "events.jsonl": 1,
    "trace.json": 1, "slo.json": 1, "fleet.json": 1,
    "timelines.json": 1, "elastic.json": 1, "multihost.json": 1,
    "host_telemetry.json": 1, "autoscale.json": 1, "history.json": 1,
    "memory.json": 1, "journal.jsonl": 1, "manifest.json": 1,
}


class BundleError(Exception):
    """Structural bundle-validation failure; codes mirror
    ``serving.wire.WireError`` (``truncated`` / ``version_skew`` /
    ``schema`` / ``checksum_mismatch``)."""

    def __init__(self, code: str, detail: str = ""):
        self.code = code
        self.detail = detail
        super().__init__(f"bundle {code}: {detail}")

    def as_dict(self) -> Dict[str, str]:
        return {"error": "bundle", "code": self.code,
                "detail": self.detail}


class FlightRecorder:
    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._spans: Deque[tuple] = deque(maxlen=capacity)
        self._metrics: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._dump_dir: Optional[str] = None
        self._slo_monitor = None
        self._router = None
        self._signals = None
        self._elastic = None
        self._multihost = None
        self._autoscale = None
        self._auto_dumped: Dict[str, str] = {}   # reason -> bundle path
        self.dumps = 0

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return flight_armed[0]

    def arm(self, capacity: Optional[int] = None,
            dump_dir: Optional[str] = None) -> "FlightRecorder":
        """Start recording. ``dump_dir`` enables :meth:`auto_dump` (the
        watchdog/NaN/degrade hooks are no-ops without it)."""
        with self._lock:
            if capacity is not None and capacity != self._capacity:
                self._capacity = capacity
                self._events = deque(self._events, maxlen=capacity)
                self._spans = deque(self._spans, maxlen=capacity)
                self._metrics = deque(self._metrics, maxlen=capacity)
            if dump_dir is not None:
                self._dump_dir = dump_dir
            flight_armed[0] = True
        return self

    def disarm(self) -> None:
        flight_armed[0] = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._spans.clear()
            self._metrics.clear()
            self._auto_dumped.clear()

    def attach_slo_monitor(self, monitor) -> None:
        """Objective states land in ``slo.json`` of every bundle."""
        self._slo_monitor = monitor

    def attach_router(self, router) -> None:
        """Fleet router: its ``statusz()`` fleet view lands in
        ``fleet.json`` of every bundle, so a ``replica_ejected_<id>``
        auto-dump is self-contained — the breaker states, per-replica
        queues and parked/probe bookkeeping at the moment of ejection
        travel with the events and spans (``FleetRouter.__init__`` wires
        this; a later fleet replaces the earlier one)."""
        self._router = router

    def attach_elastic(self, controller) -> None:
        """Elastic resize controller: its ``timeline_snapshot()`` — the
        chip-loss → checkpoint → re-shard → rejoin state machine per
        resize, with the checkpointed flight state — lands in
        ``elastic.json`` of every bundle, so a chip-loss postmortem
        embeds the resize timeline (``ElasticServingController.__init__``
        wires this; a later controller replaces the earlier one)."""
        self._elastic = controller

    def attach_multihost(self, router) -> None:
        """Multi-host fleet: its ``multihost_snapshot()`` — per-host
        endpoint health, transport stats and the page-migration timeline
        (bytes/pages/latency per transfer) — lands in ``multihost.json``
        of every bundle, so a ``host_lost_<id>`` auto-dump embeds the
        migration record (``HostFleetRouter.__init__`` wires this; a
        later fleet replaces the earlier one)."""
        self._multihost = router

    def attach_autoscale(self, controller) -> None:
        """Autoscaling control plane: its ``timeline_snapshot()`` — the
        fleet's roles, in-flight drain operations and the versioned
        ``ScaleRecord`` decision ring — lands in ``autoscale.json`` of
        every bundle, so a scaling postmortem replays the exact signal
        snapshots each decision saw (``AutoscaleController.__init__``
        wires this; a later controller replaces the earlier one)."""
        self._autoscale = controller

    def attach_signals(self, bus) -> None:
        """Sensor plane: the SignalBus's ``history_snapshot()`` — metric
        time series, smoothed signals and emitted anomalies over the
        trailing window — lands in ``history.json`` of every bundle, so
        an ejection postmortem shows the minutes BEFORE the ejection
        (``SignalBus.__init__`` wires this; a later bus replaces the
        earlier one)."""
        self._signals = bus

    # -- recording (armed-only; callers gate on flight_armed[0]) ------------

    def note_event(self, record: Dict[str, Any]) -> None:
        """Called by ``events.EventLog.emit`` with the already-built
        record dict (shared, not copied — emit never mutates it after).

        The lock matters even though ``deque.append`` is atomic:
        :meth:`arm` REBINDS the rings when it resizes them, and an
        unlocked append can land in the abandoned deque — a recorded
        event silently missing from the next debug bundle (tpu-lint
        lock-unguarded-write)."""
        with self._lock:
            self._events.append(record)

    def note_span(self, span: tuple) -> None:
        """Called by ``profiler.record`` with a ``HostSpan`` tuple."""
        with self._lock:
            self._spans.append(span)

    def note_spans(self, spans) -> None:
        """Batch variant (``record.emit_spans``): one lock round for an
        engine step's whole span set."""
        with self._lock:
            self._spans.extend(spans)

    def note_metrics(self, label: str, payload: Dict[str, Any]) -> None:
        with self._lock:
            self._metrics.append({"label": label, **payload})

    def recent_events(self, n: int = 32) -> List[Dict[str, Any]]:
        """Last ``n`` ring events, oldest first — the telemetry frame's
        event tail (:func:`~.federation.collect_telemetry`)."""
        with self._lock:
            return list(self._events)[-n:]

    # -- dumping ------------------------------------------------------------

    def snapshot_status(self) -> Dict[str, Any]:
        with self._lock:
            return {"armed": flight_armed[0], "capacity": self._capacity,
                    "events": len(self._events), "spans": len(self._spans),
                    "metric_samples": len(self._metrics),
                    "dumps": self.dumps, "dump_dir": self._dump_dir}

    def _chrome_trace(self, spans: List[tuple]) -> Dict[str, Any]:
        """Ring spans as chrome://tracing JSON (same shape as
        ``profiler.export_chrome_tracing``, minus flow events — a ring is
        a window, so chains may be torn anyway)."""
        events = []
        for sp in spans:
            ev = {"name": sp.name, "cat": sp.event_type, "ph": "X",
                  "ts": sp.start_ns / 1000.0,
                  "dur": (sp.end_ns - sp.start_ns) / 1000.0,
                  "pid": sp.pid, "tid": sp.tid}
            args = dict(sp.args or {})
            if sp.trace_id:
                args.setdefault("trace_id", sp.trace_id)
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_debug_bundle(self, path: Optional[str] = None,
                          reason: str = "manual") -> str:
        """Write the postmortem tarball; returns its path. ``path`` may
        be a target file or a directory (a timestamped name is chosen
        inside); defaults to the armed ``dump_dir`` (cwd as a last
        resort)."""
        from .registry import get_registry

        with self._lock:
            events = list(self._events)
            spans = list(self._spans)
            metric_samples = list(self._metrics)
            seq = self.dumps        # claimed under the lock: concurrent
            self.dumps += 1         # dumps get distinct bundle names
        target = path if path is not None else (self._dump_dir or ".")
        if os.path.isdir(target) or not target.endswith((".tar.gz", ".tgz")):
            os.makedirs(target, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            target = os.path.join(
                target, f"paddle_debug_{reason}_{stamp}_{os.getpid()}"
                        f"_{seq}.tar.gz")
        else:
            d = os.path.dirname(target)
            if d:
                os.makedirs(d, exist_ok=True)
        reg = get_registry()
        members: Dict[str, bytes] = {}
        schema_versions: Dict[str, int] = {}

        def _put_json(name: str, obj) -> None:
            # every JSON-object member declares its schema_version
            # inline; list members (slo.json) are versioned through the
            # manifest's schema_versions map only — their consumers
            # index them positionally and a header entry would break
            # them
            if isinstance(obj, dict):
                obj = dict(obj)
                obj.setdefault("schema_version",
                               BUNDLE_SCHEMAS.get(name, 1))
                schema_versions[name] = int(obj["schema_version"])
            else:
                schema_versions[name] = BUNDLE_SCHEMAS.get(name, 1)
            members[name] = json.dumps(
                obj, default=str, indent=1).encode()

        members["metrics.prom"] = reg.prometheus_text().encode()
        schema_versions["metrics.prom"] = BUNDLE_SCHEMAS["metrics.prom"]
        _put_json("metrics.json", reg.snapshot())
        members["events.jsonl"] = "".join(
            json.dumps(e, default=str, separators=(",", ":")) + "\n"
            for e in events).encode()
        schema_versions["events.jsonl"] = BUNDLE_SCHEMAS["events.jsonl"]
        _put_json("trace.json", self._chrome_trace(spans))
        if self._slo_monitor is not None:
            _put_json("slo.json", self._slo_monitor.states())
        if self._router is not None:
            # the fleet view at dump time; a torn router (this bundle may
            # BE the ejection postmortem) must not lose the whole bundle
            try:
                fleet = self._router.statusz()
            except Exception as e:
                fleet = {"error": repr(e)}
            _put_json("fleet.json", fleet)
        from .timeline import span_collector, timeline_armed
        if timeline_armed[0] or self._router is not None:
            # request timelines: the slowest-request exemplars (tree +
            # segments) plus every still-active trace tree — the
            # "where was each request" half of an ejection postmortem
            try:
                tz = span_collector.tracez()
            except Exception as e:
                tz = {"error": repr(e)}
            _put_json("timelines.json", tz)
        if self._elastic is not None:
            # the resize state machine (chip losses, per-phase timeline,
            # checkpointed flight state) — a torn controller must not
            # lose the bundle
            try:
                el = self._elastic.timeline_snapshot()
            except Exception as e:
                el = {"error": repr(e)}
            _put_json("elastic.json", el)
        if self._multihost is not None:
            # the multi-host fleet view: endpoint health + the page-
            # migration timeline (a torn fleet must not lose the bundle)
            try:
                mh = self._multihost.multihost_snapshot()
            except Exception as e:
                mh = {"error": repr(e)}
            _put_json("multihost.json", mh)
            hub = getattr(self._multihost, "federation", None)
            if hub is not None:
                # every host's last-known telemetry mirror — for a
                # host_lost bundle this is the dead host's final minutes,
                # frozen at mark_lost (a torn hub must not lose the
                # bundle)
                try:
                    tel = hub.snapshot()
                except Exception as e:
                    tel = {"error": repr(e)}
                _put_json("host_telemetry.json", tel)
        if self._autoscale is not None:
            # the scaling decision ring (records + the signal snapshots
            # they decided on) — a torn controller must not lose the
            # bundle
            try:
                sc = self._autoscale.timeline_snapshot()
            except Exception as e:
                sc = {"error": repr(e)}
            _put_json("autoscale.json", sc)
        if self._signals is not None:
            # the sensor plane's bounded window: series, signal trends
            # and anomalies leading up to this dump (a torn bus must not
            # lose the bundle)
            try:
                hist = self._signals.history_snapshot()
            except Exception as e:
                hist = {"error": repr(e)}
            _put_json("history.json", hist)
        from .memory import memory_armed, memory_ledger
        if memory_armed[0]:
            # the memory ledger's books: class bytes + peaks, per-pool
            # planner verdicts, per-request page holders and the last
            # OOM — an allocation failure's postmortem is the bundle
            # whose reason is ``oom_<source>``
            try:
                mem = memory_ledger.snapshot()
            except Exception as e:
                mem = {"error": repr(e)}
            _put_json("memory.json", mem)
        from .journal import journal, journal_armed
        if journal_armed[0]:
            # the black-box journal: the run's nondeterminism frontier,
            # versioned + crc-per-line — this member makes the bundle a
            # runnable incident (observability/replay.py)
            members["journal.jsonl"] = journal.encode()
            schema_versions["journal.jsonl"] = \
                BUNDLE_SCHEMAS["journal.jsonl"]
        schema_versions["manifest.json"] = BUNDLE_SCHEMAS["manifest.json"]
        members["manifest.json"] = json.dumps({
            "schema_version": BUNDLE_SCHEMAS["manifest.json"],
            "reason": reason, "pid": os.getpid(),
            "capacity": self._capacity, "events": len(events),
            "spans": len(spans), "metric_samples": len(metric_samples),
            "metric_deltas": metric_samples,
            "schema_versions": schema_versions,
        }, default=str, indent=1).encode()
        with tarfile.open(target, "w:gz") as tar:
            for name, data in members.items():
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
        from .events import emit_event
        emit_event("debug_dump", reason=reason, path=target,
                   events=len(events), spans=len(spans))
        return target

    def auto_dump(self, reason: str) -> Optional[str]:
        """Postmortem hook for the runtime (watchdog timeout, NaN
        rollback, scheduler degrade): dump once per distinct reason,
        only when armed with a dump_dir; never raises into the caller's
        failure path."""
        if not flight_armed[0] or self._dump_dir is None:
            return None
        with self._lock:
            if reason in self._auto_dumped:
                return None
            self._auto_dumped[reason] = ""   # reserve before the slow dump
        try:
            p = self.dump_debug_bundle(reason=reason)
        except Exception:
            return None
        with self._lock:
            self._auto_dumped[reason] = p
        return p


#: the process-global recorder the runtime hooks dump into
flight_recorder = FlightRecorder()


def validate_bundle(path: str) -> Dict[str, Any]:
    """THE shared structural validator for debug bundles: every member
    accounted for in the manifest's ``schema_versions`` map, every
    declared version one this tree speaks (:data:`BUNDLE_SCHEMAS`),
    every JSON member parseable with its inline ``schema_version``
    agreeing with the manifest, and an embedded ``journal.jsonl``
    passing its own versioned/checksummed decode. Raises
    :class:`BundleError` (or ``journal.JournalError`` for a torn
    journal member); returns ``{"path", "members", "manifest",
    "journal"}`` with ``journal`` a ``DecodedJournal`` or None."""
    members: Dict[str, bytes] = {}
    try:
        with tarfile.open(path, "r:gz") as tar:
            for info in tar.getmembers():
                f = tar.extractfile(info)
                members[info.name] = f.read() if f is not None else b""
    except (OSError, tarfile.TarError) as e:
        raise BundleError("truncated", f"unreadable tarball: {e!r}")
    if "manifest.json" not in members:
        raise BundleError("schema", "bundle has no manifest.json")
    try:
        manifest = json.loads(members["manifest.json"])
    except Exception:
        raise BundleError("schema", "manifest.json is not JSON")
    svs = manifest.get("schema_versions")
    if not isinstance(svs, dict):
        raise BundleError(
            "schema", "manifest declares no schema_versions map "
                      "(a bundle from before schema versions?)")
    for name in members:
        if name not in svs:
            raise BundleError(
                "schema",
                f"member {name!r} missing from manifest schema_versions")
        declared = BUNDLE_SCHEMAS.get(name)
        if declared is not None and int(svs[name]) != declared:
            raise BundleError(
                "version_skew",
                f"{name}: bundle declares schema_version {svs[name]}, "
                f"this tree speaks {declared}")
    for name, data in members.items():
        if name.endswith(".json"):
            try:
                obj = json.loads(data)
            except Exception:
                raise BundleError("schema", f"{name} is not valid JSON")
            if isinstance(obj, dict) \
                    and obj.get("schema_version") != int(svs[name]):
                raise BundleError(
                    "schema",
                    f"{name}: inline schema_version "
                    f"{obj.get('schema_version')!r} != manifest "
                    f"{svs[name]}")
        elif name == "events.jsonl":
            lines = data.decode("utf-8", errors="replace").splitlines()
            for i, line in enumerate(lines):
                if not line:
                    continue
                try:
                    json.loads(line)
                except Exception:
                    raise BundleError(
                        "schema", f"events.jsonl line {i} is not JSON")
    decoded = None
    if "journal.jsonl" in members:
        from .journal import decode_journal
        decoded = decode_journal(members["journal.jsonl"])
    return {"path": path, "members": members, "manifest": manifest,
            "journal": decoded}
