"""Fleet-wide observability federation — counterpart of
``paddle_tpu/observability/federation.py``: per-host telemetry mirrors,
clock-offset estimation and merged cross-host surfaces.

Serving runs in engine processes (``serving/multihost.py``), while every
observability plane — :class:`~.registry.MetricsRegistry`,
:class:`~.timeline.SpanCollector`, :class:`~.signals.SignalBus`, the
event log, flight bundles — is process-local. This module is the parent
half of the federation:

* each heartbeat the host ships a **versioned telemetry frame**
  (:func:`collect_telemetry`, marshalled by ``serving.wire``): its
  registry exposition text, serving gauges, SignalBus values + trends,
  the span collector's *new* completed spans since the last frame
  (per-trace watermarks — :meth:`.timeline.SpanCollector.export_new`),
  the flight ring's event tail and the memory ledger's class bytes;
* the parent keeps a :class:`HostTelemetryMirror` per host inside a
  :class:`FederationHub`, with **clock-offset estimation** from RPC
  request/reply midpoints (:class:`ClockSync`): ``offset = t_remote -
  (t_send + t_recv) / 2``, EWMA-smoothed, with ``rtt / 2`` as the error
  bound — the remote clock is *corrected, never trusted*. Remote span
  timestamps are skew-corrected into the parent's clock domain and
  injected into the parent's span collector, so spans from different
  hosts merge into ONE trace tree at ``/tracez`` and the exclusive-sweep
  attribution grows ``migration`` / ``dcn_transfer`` segments that tile
  the root envelope exactly;
* federated surfaces: :meth:`FederationHub.federated_metrics_text`
  merges every mirror's exposition doc with the parent's into one
  validator-clean document under a ``host`` label
  (:func:`merge_expositions`; the same inputs give the reference's bytes);
  :meth:`attach_fleet_signals` registers per-host + fleet-aggregate EWMA
  signals (queue depth, pool pressure, burn rate, ``host_rtt_p90``) on a
  :class:`~.signals.SignalBus` for ``/varz``; and
  :meth:`FederationHub.snapshot` is the ``host_telemetry.json`` member
  flight bundles embed, so a ``host_lost`` postmortem shows the dead
  host's last-known telemetry, not just the moment of death.

Hot-path contract: the heartbeat path checks the module-level
``federation_armed`` cell (one list index disarmed) — the same
zero-overhead discipline as the flight recorder / timeline planes.

Layering: this module never imports ``serving`` — frame *marshalling*
(versioning, wire rejection) lives in ``serving/wire.py``; this module
only builds and consumes plain frame dicts. It is host code only: no
tensor, no device.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .format import HELP_PREFIX, TYPE_PREFIX, help_line, type_line
from .registry import get_registry
from .timeline import span_collector, timeline_armed

#: the one cell heartbeat call sites check before doing federation work
#: (mutable list so callers read a stable module attribute)
federation_armed = [False]

#: telemetry frame fields every well-formed frame must carry
FRAME_REQUIRED_KEYS = ("host_id", "pid", "seq", "t_ns")


def _utcnow_label() -> float:
    """Monotonic seconds for mirror freshness bookkeeping (overridable
    per-hub via the injected clock)."""
    return time.monotonic()


# ---------------------------------------------------------------------------
# clock-offset estimation
# ---------------------------------------------------------------------------

class ClockSync:
    """Peer clock-offset estimator over RPC round-trips.

    For one request/reply pair, ``t_send``/``t_recv`` are the local
    clock at send and receive and ``t_remote`` is the peer's clock when
    it built the reply. Assuming the reply was stamped near the midpoint
    of the round-trip, the offset sample is ``t_remote - (t_send +
    t_recv) / 2`` and its worst-case error is ``rtt / 2`` (the stamp
    could sit anywhere in the window). Both are EWMA-smoothed; a bounded
    deque of raw RTTs feeds quantile reads (``host_rtt_p90``). Units are
    whatever the caller feeds (the serving heartbeat uses
    ``perf_counter_ns`` on both sides).
    """

    def __init__(self, alpha: float = 0.3, window: int = 64):
        self.alpha = float(alpha)
        self.offset_ns: Optional[float] = None
        self.error_bound_ns: Optional[float] = None
        self.samples = 0
        self._rtts: deque = deque(maxlen=window)

    def observe(self, t_send_ns: float, t_recv_ns: float,
                t_remote_ns: float) -> None:
        rtt = t_recv_ns - t_send_ns
        if rtt < 0:                      # clock went backwards: discard
            return
        offset = t_remote_ns - (t_send_ns + t_recv_ns) / 2.0
        half = rtt / 2.0
        self._rtts.append(rtt)
        self.samples += 1
        if self.offset_ns is None:
            self.offset_ns = offset
            self.error_bound_ns = half
        else:
            a = self.alpha
            self.offset_ns = a * offset + (1.0 - a) * self.offset_ns
            self.error_bound_ns = a * half + (1.0 - a) * self.error_bound_ns

    def correct(self, t_remote_ns: float) -> int:
        """Map a remote timestamp into the local clock domain."""
        return int(round(t_remote_ns - (self.offset_ns or 0.0)))

    def rtt_quantile(self, q: float) -> float:
        """Empirical RTT quantile over the retained window (0 when no
        samples yet)."""
        if not self._rtts:
            return 0.0
        ordered = sorted(self._rtts)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return float(ordered[idx])

    def snapshot(self) -> Dict[str, Any]:
        return {
            "samples": self.samples,
            "offset_ms": None if self.offset_ns is None
            else round(self.offset_ns / 1e6, 6),
            "error_bound_ms": None if self.error_bound_ns is None
            else round(self.error_bound_ns / 1e6, 6),
            "rtt_p50_ms": round(self.rtt_quantile(0.5) / 1e6, 6),
            "rtt_p90_ms": round(self.rtt_quantile(0.9) / 1e6, 6),
        }


# ---------------------------------------------------------------------------
# host-side frame building
# ---------------------------------------------------------------------------

def _span_as_dict(sp) -> Dict[str, Any]:
    return {"name": sp.name, "event_type": sp.event_type,
            "start_ns": int(sp.start_ns), "end_ns": int(sp.end_ns),
            "trace_id": sp.trace_id,
            "args": dict(sp.args) if sp.args else None}


def collect_telemetry(host_id: int, span_marks: Dict[str, int], seq: int,
                      registry=None, collector=None, signal_bus=None,
                      gauges: Optional[Dict[str, float]] = None,
                      event_tail: int = 32) -> Dict[str, Any]:
    """Build one telemetry frame on the HOST side (the ``telemetry``
    wire command's reply body). ``span_marks`` is the caller-owned
    per-trace watermark dict — each call exports only spans recorded
    since the previous call, so frames stay heartbeat-sized."""
    from .flight import flight_armed, flight_recorder
    from .memory import MEM_CLASSES, memory_ledger
    reg = registry if registry is not None else get_registry()
    coll = collector if collector is not None else span_collector
    return {
        "host_id": int(host_id),
        "pid": os.getpid(),
        "seq": int(seq),
        "t_ns": time.perf_counter_ns(),
        "metrics_text": reg.prometheus_text(),
        "gauges": {k: float(v) for k, v in (gauges or {}).items()},
        "signals": signal_bus.values() if signal_bus is not None else {},
        "events": (flight_recorder.recent_events(event_tail)
                   if flight_armed[0] else []),
        "memory": {c: memory_ledger.class_bytes(c) for c in MEM_CLASSES},
        "spans": [_span_as_dict(sp) for sp in coll.export_new(span_marks)],
    }


# ---------------------------------------------------------------------------
# exposition merging
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?( .*)$")


def _add_host_label(line: str, host: str) -> str:
    """Insert ``host="<host>"`` as the FIRST label of a sample line.
    First position keeps per-host histogram buckets accumulating
    independently under the validator (its key is the prefix before
    ``le=``). Samples that already carry a host label (the parent's own
    ``paddle_host_state{host=...}``) pass through unchanged."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return line
    name, labels, rest = m.group(1), m.group(2), m.group(3)
    if labels:
        if 'host="' in labels:
            return line
        return f'{name}{{host="{host}",{labels[1:]}{rest}'
    return f'{name}{{host="{host}"}}{rest}'


def merge_expositions(docs: Dict[str, str]) -> str:
    """Merge per-host exposition documents into ONE valid document:
    every family TYPE'd once, every sample labeled with its ``host``,
    families emitted in sorted name order, hosts in deterministic order
    (``parent`` first, then sorted) — same inputs, byte-identical
    output. Each input doc is parsed sequentially (samples after a TYPE
    line belong to that family, the shape ``observability.format``
    always emits)."""
    order = sorted(docs)
    if "parent" in docs:
        order.remove("parent")
        order.insert(0, "parent")
    fam_type: Dict[str, str] = {}
    fam_help: Dict[str, str] = {}
    fam_order: List[str] = []
    fam_samples: Dict[str, List[str]] = {}
    loose: List[str] = []                # samples before any TYPE line
    for host in order:
        text = docs.get(host) or ""
        fam = None
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith(HELP_PREFIX):
                parts = line.split(" ", 3)
                if len(parts) == 4:
                    fam_help.setdefault(parts[2], parts[3])
                continue
            if line.startswith(TYPE_PREFIX):
                parts = line.split(" ")
                if len(parts) != 4:
                    continue
                fam = parts[2]
                if fam not in fam_type:
                    fam_type[fam] = parts[3]
                    fam_order.append(fam)
                    fam_samples[fam] = []
                continue
            if line.startswith("#"):
                continue
            stamped = _add_host_label(line, host)
            if fam is None:
                loose.append(stamped)
            else:
                fam_samples[fam].append(stamped)
    lines: List[str] = []
    for fam in sorted(fam_order):
        if fam in fam_help:
            lines.append(help_line(fam, fam_help[fam]))
        lines.append(type_line(fam, fam_type[fam]))
        lines.extend(fam_samples[fam])
    lines.extend(loose)
    return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# parent-side mirrors
# ---------------------------------------------------------------------------

class HostTelemetryMirror:
    """The parent's last-known view of one host's telemetry plane."""

    __slots__ = ("host_id", "clock", "frame", "seq", "frames",
                 "spans_merged", "stale", "stale_error", "lost",
                 "last_ingest_t")

    def __init__(self, host_id: int):
        self.host_id = int(host_id)
        self.clock = ClockSync()
        self.frame: Optional[Dict[str, Any]] = None
        self.seq = -1
        self.frames = 0
        self.spans_merged = 0
        self.stale = True                # no frame yet
        self.stale_error: Optional[str] = None
        self.lost = False
        self.last_ingest_t: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "host_id": self.host_id,
            "stale": self.stale,
            "stale_error": self.stale_error,
            "lost": self.lost,
            "seq": self.seq,
            "frames": self.frames,
            "spans_merged": self.spans_merged,
            "last_ingest_t": None if self.last_ingest_t is None
            else round(self.last_ingest_t, 6),
            "clock": self.clock.snapshot(),
            "frame": self.frame,
        }


class FederationHub:
    """Parent-side federation state: one :class:`HostTelemetryMirror`
    per host, span re-injection into the parent collector, federated
    ``/metrics`` / ``/varz`` / bundle surfaces. See module docstring."""

    def __init__(self, collector=None, registry=None,
                 clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._mirrors: Dict[int, HostTelemetryMirror] = {}
        self._collector = collector if collector is not None \
            else span_collector
        self._clock = clock if clock is not None else _utcnow_label
        reg = registry if registry is not None else get_registry()
        self._registry = reg
        self._c_frames = reg.counter(
            "paddle_federation_frames_total",
            "telemetry frames ingested per host", labels=("host",))
        self._c_spans = reg.counter(
            "paddle_federation_spans_merged_total",
            "remote spans skew-corrected into the parent trace trees",
            labels=("host",))
        self._g_offset = reg.gauge(
            "paddle_federation_clock_offset_seconds",
            "EWMA clock offset (remote - local midpoint) per host",
            labels=("host",))
        self._g_bound = reg.gauge(
            "paddle_federation_clock_error_bound_seconds",
            "EWMA offset error bound (RTT/2) per host", labels=("host",))
        self._g_stale = reg.gauge(
            "paddle_federation_stale_mirrors",
            "host mirrors currently stale or lost")

    # -- lifecycle ----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return federation_armed[0]

    def arm(self) -> "FederationHub":
        federation_armed[0] = True
        return self

    def disarm(self) -> None:
        federation_armed[0] = False

    # -- mirror bookkeeping -------------------------------------------------

    def _mirror_locked(self, host_id: int) -> HostTelemetryMirror:
        m = self._mirrors.get(int(host_id))
        if m is None:
            m = self._mirrors[int(host_id)] = HostTelemetryMirror(host_id)
        return m

    def mirror(self, host_id: int) -> HostTelemetryMirror:
        with self._lock:
            return self._mirror_locked(host_id)

    def hosts(self) -> List[int]:
        with self._lock:
            return sorted(self._mirrors)

    def _publish_stale_locked(self) -> None:
        self._g_stale.set(float(sum(
            1 for m in self._mirrors.values() if m.stale or m.lost)))

    # -- ingestion ----------------------------------------------------------

    def observe_rtt(self, host_id: int, t_send_ns: float,
                    t_recv_ns: float, t_remote_ns: float) -> None:
        """Feed one heartbeat round-trip into the host's clock estimator
        and publish the offset/bound gauges."""
        with self._lock:
            m = self._mirror_locked(host_id)
            m.clock.observe(t_send_ns, t_recv_ns, t_remote_ns)
            offset, bound = m.clock.offset_ns, m.clock.error_bound_ns
        label = f"h{int(host_id)}"
        if offset is not None:
            self._g_offset.set(offset / 1e9, host=label)
        if bound is not None:
            self._g_bound.set(bound / 1e9, host=label)

    def ingest(self, host_id: int, frame: Dict[str, Any],
               t_send_ns: Optional[float] = None,
               t_recv_ns: Optional[float] = None) -> int:
        """Fold one telemetry frame into the host's mirror. When the
        round-trip timestamps are given they feed the clock estimator
        (the frame's ``t_ns`` is the remote reply stamp). Remote spans
        are skew-corrected and re-injected into the parent collector —
        skipped when the frame came from THIS process (LocalTransport:
        the spans already live in the shared collector). Returns the
        number of spans merged."""
        spans_in = frame.get("spans") or []
        with self._lock:
            m = self._mirror_locked(host_id)
            if m.lost:
                return 0                 # a dead host's mirror is frozen
            seq = int(frame.get("seq", 0))
            if m.frame is not None and seq <= m.seq:
                return 0                 # stale / duplicate frame
            if t_send_ns is not None and t_recv_ns is not None \
                    and "t_ns" in frame:
                m.clock.observe(t_send_ns, t_recv_ns, frame["t_ns"])
            m.frame = frame
            m.seq = seq
            m.frames += 1
            m.stale = False
            m.stale_error = None
            m.last_ingest_t = self._clock()
            offset = m.clock.offset_ns or 0.0
            bound = m.clock.error_bound_ns
            self._publish_stale_locked()
        label = f"h{int(host_id)}"
        self._c_frames.inc(host=label)
        self._g_offset.set(offset / 1e9, host=label)
        if bound is not None:
            self._g_bound.set(bound / 1e9, host=label)
        merged = 0
        if spans_in and timeline_armed[0] \
                and int(frame.get("pid", -1)) != os.getpid():
            from ..profiler.record import HostSpan
            spans = []
            for d in spans_in:
                args = dict(d.get("args") or {})
                args["host"] = int(host_id)
                spans.append(HostSpan(
                    d["name"], d.get("event_type", "UserDefined"),
                    int(round(d["start_ns"] - offset)),
                    int(round(d["end_ns"] - offset)),
                    0, int(frame.get("pid", 0)),
                    d.get("trace_id", ""), args))
            self._collector.note_spans(spans)
            merged = len(spans)
            with self._lock:
                m.spans_merged += merged
            self._c_spans.inc(merged, host=label)
        return merged

    def mark_stale(self, host_id: int, detail: str = "") -> None:
        """A telemetry round-trip failed: the mirror keeps its last
        frame but is flagged stale (federated surfaces say so)."""
        with self._lock:
            m = self._mirror_locked(host_id)
            m.stale = True
            m.stale_error = detail or m.stale_error
            self._publish_stale_locked()

    def mark_lost(self, host_id: int) -> None:
        """The host died: freeze its mirror as the last-known telemetry
        (the ``host_lost`` bundle embeds it via :meth:`snapshot`)."""
        with self._lock:
            m = self._mirror_locked(host_id)
            m.lost = True
            m.stale = True
            self._publish_stale_locked()

    # -- federated surfaces -------------------------------------------------

    def federated_metrics_text(self) -> str:
        """ONE exposition document covering the parent and every mirror
        under a ``host`` label (``host="parent"`` for this process)."""
        docs = {"parent": self._registry.prometheus_text()}
        with self._lock:
            mirrors = [(m.host_id, m.frame) for m in self._mirrors.values()
                       if m.frame is not None]
        for hid, frame in mirrors:
            text = frame.get("metrics_text")
            if text and int(frame.get("pid", -1)) != os.getpid():
                # LocalTransport mirrors share this process registry —
                # their families are already in the parent doc
                docs[f"h{hid}"] = text
        return merge_expositions(docs)

    def attach_fleet_signals(self, bus) -> "FederationHub":
        """Register per-host + fleet-aggregate signals on a
        :class:`~.signals.SignalBus` (the /varz fleet view and the
        autoscaler's input). Per-host signals cover the hosts
        known at attach time; fleet aggregates read the live mirror set."""
        with self._lock:
            hids = sorted(self._mirrors)
        for hid in hids:
            m = self.mirror(hid)
            bus.signal(f"h{hid}.queue_depth",
                       lambda m=m: _mirror_gauge(m, "queue_depth"))
            bus.signal(f"h{hid}.rtt_ms",
                       lambda m=m: m.clock.rtt_quantile(0.5) / 1e6)
            bus.signal(f"h{hid}.offset_ms",
                       lambda m=m: (m.clock.offset_ns or 0.0) / 1e6,
                       detect=False)
        bus.signal("fleet.queue_depth", self._fleet_queue_depth)
        bus.signal("fleet.pool_pressure", self._fleet_pool_pressure)
        bus.signal("fleet.burn_rate", self._fleet_burn_rate)
        bus.signal("host_rtt_p90", self._host_rtt_p90, detect=False)
        return self

    def _live_mirrors(self) -> List[HostTelemetryMirror]:
        with self._lock:
            return [m for m in self._mirrors.values() if not m.lost]

    def _fleet_queue_depth(self) -> float:
        return sum(_mirror_gauge(m, "queue_depth")
                   for m in self._live_mirrors())

    def _fleet_pool_pressure(self) -> float:
        return max((_mirror_gauge(m, "page_utilization")
                    for m in self._live_mirrors()), default=0.0)

    def _fleet_burn_rate(self) -> float:
        out = 0.0
        for m in self._live_mirrors():
            sig = (m.frame or {}).get("signals") or {}
            for name, st in sig.items():
                if name.endswith("slo_burn") and st.get("value"):
                    out = max(out, float(st["value"]))
        return out

    def _host_rtt_p90(self) -> float:
        """Worst p90 heartbeat RTT across live hosts, in seconds."""
        return max((m.clock.rtt_quantile(0.9) / 1e9
                    for m in self._live_mirrors()), default=0.0)

    def reconcile_error_s(self) -> float:
        """Worst clock-offset error bound across live mirrors, seconds —
        the federation's cross-host timestamp reconciliation error."""
        return max(((m.clock.error_bound_ns or 0.0) / 1e9
                    for m in self._live_mirrors()), default=0.0)

    def fleet_varz(self) -> Dict[str, Any]:
        """Compact fleet view for /varz and statusz."""
        with self._lock:
            hosts = {f"h{hid}": {
                "stale": m.stale, "lost": m.lost, "seq": m.seq,
                "frames": m.frames, "spans_merged": m.spans_merged,
                "clock": m.clock.snapshot(),
            } for hid, m in sorted(self._mirrors.items())}
        return {"armed": federation_armed[0],
                "reconcile_error_ms": round(
                    self.reconcile_error_s() * 1e3, 6),
                "hosts": hosts}

    def snapshot(self) -> Dict[str, Any]:
        """The ``host_telemetry.json`` bundle member: every mirror's
        full last-known frame + clock state."""
        with self._lock:
            hosts = {f"h{hid}": m.as_dict()
                     for hid, m in sorted(self._mirrors.items())}
        return {"schema_version": 1,
                "kind": "paddle_tpu.host_telemetry",
                "armed": federation_armed[0],
                "hosts": hosts}


def _mirror_gauge(m: HostTelemetryMirror, name: str) -> float:
    frame = m.frame
    if not frame:
        return 0.0
    return float((frame.get("gauges") or {}).get(name, 0.0))
