"""Live diagnostics server — the process's operable surface; counterpart
of ``paddle_tpu/observability/server.py``.

A stdlib-only (``http.server`` on a daemon thread) debug endpoint; the
one place in the package that opens a listening socket for
diagnostics:

========== ==============================================================
route      serves
========== ==============================================================
/metrics   the registry's Prometheus exposition, byte-identical to
           ``registry.prometheus_text()`` (scrape target)
/healthz   SLO-aware health: ``ok`` | ``degraded`` | ``breached`` as
           JSON; HTTP 200 while serving is viable, 503 on breach
           (load-balancer ready-check semantics)
/statusz   one JSON document from every registered provider (scheduler
           queues, kvcache pages, goodput breakdown, SLO states,
           flight-recorder status)
/debugz    flight-recorder status; ``?dump=1`` writes a postmortem
           bundle (``dump_debug_bundle``) and returns its path
/tracez    request timelines from the span collector: the slowest
           requests (span tree + exclusive critical-path segments) and
           every still-active trace tree (``?trace=<id>`` narrows to
           one trace's tree + attribution)
/varz      the sensor plane's live signal document (``SignalBus.varz``
           via :meth:`DiagServer.attach_signals`): smoothed signal
           values + windowed trends, per-series anomaly state, history
           ring status — the autoscaler's decision inputs
/memz      the HBM memory ledger (``observability.memory``): device
           bytes by class + peak watermarks, per-pool planner verdicts,
           per-request page holders, prefix-cache stats and the last
           OOM — the same document every flight bundle embeds as
           ``memory.json``
/journalz  the black-box incident journal (``observability.journal``):
           armed state, ring occupancy, drop count; ``?tail=N`` adds
           the last N frames — the live view of what a postmortem
           replay would re-execute
/scalez    the autoscaling control plane (``AutoscaleController.
           timeline_snapshot`` via :meth:`DiagServer.attach_autoscale`):
           fleet roles, in-flight drain operations and the versioned
           ScaleRecord decision ring — each record carries the exact
           signal snapshot it decided on
========== ==============================================================

Providers are callables returning JSON-able data, registered with
:meth:`DiagServer.add_statusz` or via the ``attach_*`` conveniences.
Handlers never let a torn provider kill the scrape: a provider raising
turns into an ``{"error": …}`` entry, the rest of the page still
renders.

Usage::

    srv = DiagServer(monitor=slo_monitor)       # port=0: ephemeral
    srv.attach_scheduler(sched)
    port = srv.start()
    ...
    curl http://127.0.0.1:{port}/healthz
    srv.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .flight import flight_recorder
from .journal import journal
from .memory import memory_ledger
from .registry import get_registry
from .timeline import span_collector

#: health states, ordered by severity (max wins when composing sources)
_HEALTH_ORDER = {"ok": 0, "degraded": 1, "breached": 2}


class DiagServer:
    """See module docstring. ``port=0`` binds an ephemeral port (tests);
    ``registry=None`` uses the process-global one."""

    def __init__(self, registry=None, monitor=None,
                 host: str = "127.0.0.1", port: int = 0,
                 flight=None):
        self.registry = registry if registry is not None else get_registry()
        self.monitor = monitor
        self.flight = flight if flight is not None else flight_recorder
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._statusz: Dict[str, Callable[[], object]] = {}
        self._health_fns: Dict[str, Callable[[], str]] = {}
        self._signals = None
        self._federation = None
        self._autoscale = None
        if monitor is not None:
            self.add_health_source("slo", monitor.health)
            self.add_statusz("slo", monitor.states)
        self.add_statusz("flight_recorder", self.flight.snapshot_status)
        # request-timeline summary (slowest-requests table) rides along
        # whenever the span collector is armed; /tracez serves the trees
        self.add_statusz("timelines", span_collector.snapshot_status)
        # HBM ledger summary (class bytes + planner verdicts); the full
        # per-request document is /memz
        self.add_statusz("memory", memory_ledger.statusz)
        # incident-journal ring occupancy; the frame tail is /journalz
        self.add_statusz("journal", journal.snapshot_status)

    # -- wiring -------------------------------------------------------------

    def add_statusz(self, name: str, fn: Callable[[], object]) -> None:
        """Register a /statusz section; ``fn`` returns JSON-able data."""
        self._statusz[name] = fn

    def add_health_source(self, name: str,
                          fn: Callable[[], str]) -> None:
        """Register a health contributor returning ``ok`` | ``degraded``
        | ``breached``; /healthz reports the worst across sources."""
        self._health_fns[name] = fn

    def attach_scheduler(self, sched) -> None:
        """Serving scheduler: queue/slot/page state on /statusz, its
        degraded latch as a health source."""
        self.add_statusz("serving", sched.statusz)
        self.add_health_source(
            "serving", lambda: "breached" if sched.degraded else "ok")

    def attach_router(self, router) -> None:
        """Fleet router: the whole-fleet /statusz view (per-replica
        scheduler + breaker state) and fleet health — 503 only once NO
        replica can take traffic."""
        self.add_statusz("router", router.statusz)
        self.add_health_source("router", router.fleet_health)

    def attach_goodput(self, tracker) -> None:
        self.add_statusz("goodput", tracker.breakdown)

    def attach_signals(self, bus) -> None:
        """Sensor plane: mounts the SignalBus at ``/varz`` and a signal
        summary on /statusz."""
        self._signals = bus
        self.add_statusz("signals", bus.values)

    def attach_kvcache(self, cache) -> None:
        self.add_statusz("kvcache", cache.statusz)

    def attach_autoscale(self, controller) -> None:
        """Autoscaling control plane: mounts the controller's
        ``timeline_snapshot()`` (fleet roles, in-flight operations, the
        versioned ScaleRecord decision ring with the signal snapshots
        each decision saw) at ``/scalez`` and a summary on /statusz."""
        self._autoscale = controller
        self.add_statusz("autoscale", controller.timeline_snapshot)

    def attach_federation(self, hub) -> None:
        """Telemetry federation (:class:`~.federation.FederationHub`):
        /metrics becomes ONE merged exposition doc covering the parent
        and every host mirror under a ``host`` label, and the fleet view
        (mirror freshness, clock offsets, reconcile error) joins
        /statusz. The per-host + fleet-aggregate signals reach /varz by
        also calling ``hub.attach_fleet_signals(bus)`` on the attached
        SignalBus."""
        self._federation = hub
        self.add_statusz("federation", hub.fleet_varz)

    # -- derived health -----------------------------------------------------

    def health(self) -> str:
        worst = "ok"
        for fn in self._health_fns.values():
            try:
                state = fn()
            except Exception:
                state = "degraded"          # a torn source is suspicious
            if _HEALTH_ORDER.get(state, 1) > _HEALTH_ORDER[worst]:
                worst = state
        return worst

    def statusz(self) -> Dict[str, object]:
        out: Dict[str, object] = {"health": self.health()}
        for name, fn in self._statusz.items():
            try:
                out[name] = fn()
            except Exception as e:          # page still renders
                out[name] = {"error": repr(e)}
        return out

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):        # noqa: ARG002 - quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):                    # noqa: N802 - stdlib API
                try:
                    url = urlparse(self.path)
                    route = url.path.rstrip("/") or "/"
                    if route == "/metrics":
                        # byte-identical to registry.prometheus_text();
                        # with a federation attached, one merged doc
                        # covering every host under a `host` label
                        if server._federation is not None:
                            text = (server._federation
                                    .federated_metrics_text())
                        else:
                            text = server.registry.prometheus_text()
                        self._send(200, text.encode("utf-8"),
                                   ctype="text/plain; version=0.0.4; "
                                         "charset=utf-8")
                    elif route == "/healthz":
                        state = server.health()
                        self._send(503 if state == "breached" else 200,
                                   json.dumps({"status": state}).encode())
                    elif route == "/statusz":
                        self._send(200, json.dumps(
                            server.statusz(), default=str,
                            indent=1).encode())
                    elif route == "/tracez":
                        q = parse_qs(url.query)
                        tid = q.get("trace", [None])[0]
                        if tid:
                            body = {"trace_id": tid,
                                    "timeline":
                                        span_collector.attribute(tid),
                                    "tree": span_collector.tree(tid)}
                        else:
                            body = span_collector.tracez()
                        self._send(200, json.dumps(
                            body, default=str, indent=1).encode())
                    elif route == "/varz":
                        if server._signals is None:
                            self._send(404, json.dumps(
                                {"error": "no signal bus attached"}
                            ).encode())
                        else:
                            self._send(200, json.dumps(
                                server._signals.varz(), default=str,
                                indent=1).encode())
                    elif route == "/scalez":
                        if server._autoscale is None:
                            self._send(404, json.dumps(
                                {"error": "no autoscaler attached"}
                            ).encode())
                        else:
                            self._send(200, json.dumps(
                                server._autoscale.timeline_snapshot(),
                                default=str, indent=1).encode())
                    elif route == "/journalz":
                        q = parse_qs(url.query)
                        body = journal.snapshot_status()
                        tail = q.get("tail", [None])[0]
                        if tail:
                            body["tail"] = journal.tail(int(tail))
                        self._send(200, json.dumps(
                            body, default=str, indent=1).encode())
                    elif route == "/memz":
                        self._send(200, json.dumps(
                            memory_ledger.snapshot(), default=str,
                            indent=1).encode())
                    elif route == "/debugz":
                        q = parse_qs(url.query)
                        if q.get("dump", ["0"])[0] == "1":
                            path = server.flight.dump_debug_bundle(
                                reason="debugz")
                            body = {"dumped": path}
                        else:
                            body = server.flight.snapshot_status()
                        self._send(200, json.dumps(
                            body, default=str).encode())
                    elif route == "/":
                        self._send(200, json.dumps({
                            "endpoints": ["/metrics", "/healthz",
                                          "/statusz", "/debugz",
                                          "/tracez", "/varz", "/memz",
                                          "/journalz", "/scalez"],
                        }).encode())
                    else:
                        self._send(404, b'{"error":"not found"}')
                except BrokenPipeError:          # client went away
                    pass
                except Exception as e:           # never kill the server
                    try:
                        self._send(500, json.dumps(
                            {"error": repr(e)}).encode())
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle-diagserver",
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "DiagServer":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
