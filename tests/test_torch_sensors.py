"""The sensor plane and the diagnostics server: ``paddle_tpu_torch.
observability`` ``anomaly``, ``goodput``, ``signals``, ``catalog`` and
``server`` against the JAX package's, on the CPU.

The cases of the JAX package's ``tests/test_sensors.py`` and the
goodput / DiagServer cases of ``tests/test_slo_diag.py`` run through
both stacks (serving ones over ``llama_tiny`` with the same weights and
a fake clock) and must return equal snapshots: fired anomalies, detector
state, goodput breakdowns, signal values and the bus's ``varz`` and
``history.json`` documents, and the DiagServer's route bodies on equal
content. The port's catalog declares the reference's entries exactly."""

import json
import tarfile
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.observability as JO
import paddle_tpu.observability.anomaly as JAN
import paddle_tpu.observability.catalog as JCAT
import paddle_tpu.observability.events as JEV
import paddle_tpu.observability.signals as JSG
import paddle_tpu.observability.timeseries as JTS
import paddle_tpu.serving as JSV
import paddle_tpu_torch.observability as TO
import paddle_tpu_torch.observability.anomaly as TAN
import paddle_tpu_torch.observability.catalog as TCAT
import paddle_tpu_torch.observability.events as TEV
import paddle_tpu_torch.observability.signals as TSG
import paddle_tpu_torch.observability.timeseries as TTS
import paddle_tpu_torch.serving as TSV
from paddle_tpu.inference import decoding as JD
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.testing import one_cpu_thread
from test_torch_router import _weights

one_cpu_thread()

STACKS = {
    "jax": SimpleNamespace(name="jax", O=JO, AN=JAN, SG=JSG, TS=JTS,
                           EV=JEV, SV=JSV, D=JD, dev={}),
    "torch": SimpleNamespace(name="torch", O=TO, AN=TAN, SG=TSG, TS=TTS,
                             EV=TEV, SV=TSV, D=TD, dev={"device": "cpu"}),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def _reset(st):
    """Sensor-plane globals back to disarmed/unattached (a router, bus or
    controller an earlier test built stays attached to the process-wide
    flight recorder and adds members to its bundles)."""
    st.TS.history_armed[0] = False
    fr = st.O.flight_recorder
    fr.disarm()
    fr.clear()
    fr._signals = fr._router = fr._autoscale = fr._slo_monitor = None
    fr._dump_dir = None


@pytest.fixture()
def clean_plane():
    yield
    for st in STACKS.values():
        _reset(st)


def _setup_serving(st, max_new=4, num_slots=2, chunk=2, seed=3,
                   clock=None, prefix_cache=False, **sched_kw):
    cfg, params = _weights(st, seed)
    eng = st.D.ContinuousBatchingEngine(
        cfg, st.D.GenerationConfig(max_new_tokens=max_new, seed=seed),
        num_slots=num_slots, page_size=4, max_seq_len=32, chunk=chunk,
        prefix_cache=prefix_cache, **st.dev)
    kw = {"clock": clock, "sleep": lambda s: None} if clock else {}
    sched = st.SV.ServingScheduler(eng, st.SV.SchedulerConfig(**sched_kw),
                                   **kw)
    return params, eng, sched


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _level_series():
    return [1.0 + 0.01 * (i % 3) for i in range(40)] + [5.0] * 20


def _drift_series():
    out = []
    for i in range(120):
        base = 1.0 + 0.02 * ((i * 7) % 5)
        out.append(base + 0.01 * max(0, i - 40))
    return out


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# anomaly detection and goodput (tests/test_sensors.py, test_slo_diag.py)
# ---------------------------------------------------------------------------

@case
def straggler_detector_delegates_to_shared_zscore(st):
    det = st.O.StragglerDetector(window=16, z_threshold=4.0, min_samples=8)
    for v in [0.1, 0.11, 0.1, 0.09, 0.1, 0.12, 0.1, 0.11, 0.1]:
        det.observe(v, source="delegate_test")
    z = det.zscore(0.5)
    assert z == st.O.robust_zscore(0.5, det._samples, det.min_samples)
    assert st.O.robust_zscore(9.9, [1.0, 1.0], min_samples=8) == 0.0
    z2 = st.O.robust_zscore(0.2, [0.1] * 10)
    assert z2 == pytest.approx((0.2 - 0.1) / (0.1 * 0.05))
    return dict(z=z, z2=z2)


@case
def median_mad_primitives(st):
    out = (st.AN.median([3.0, 1.0, 2.0]), st.AN.median([4.0, 1.0, 2.0, 3.0]),
           st.AN.mad([1.0, 2.0, 3.0, 4.0, 100.0]))
    assert out == (2.0, 2.5, 1.0)
    return dict(out=out)


@case
def level_shift_fires_exactly_once_with_cooldown(st):
    mon = st.O.AnomalyMonitor(cooldown_s=1000.0, detector_factory=lambda: [
        st.O.RobustZScoreDetector(window=32, z_threshold=6.0,
                                  min_samples=8)])
    fired = []
    for i, v in enumerate(_level_series()):
        fired += mon.observe("itl_ms", v, float(i))
    assert len(fired) == 1 and fired[0]["t"] == 40.0
    assert (fired[0]["detector"], fired[0]["direction"]) == ("zscore", "up")
    snap = mon.snapshot()["itl_ms"]
    assert snap["fired"] == 1 and snap["suppressed"] > 0
    return dict(fired=fired, snap=mon.snapshot(), recent=mon.recent())


@case
def slow_drift_cusum_fires_once(st):
    mon = st.O.AnomalyMonitor(cooldown_s=1000.0, detector_factory=lambda: [
        st.O.CusumDetector(k=0.5, h=8.0, baseline=24)])
    zmon = st.O.AnomalyMonitor(cooldown_s=1000.0, detector_factory=lambda: [
        st.O.RobustZScoreDetector(window=16, z_threshold=8.0,
                                  min_samples=8)])
    fired, zfired = [], []
    for i, v in enumerate(_drift_series()):
        fired += mon.observe("burn", v, float(i))
        zfired += zmon.observe("burn", v, float(i))
    assert len(fired) == 1 and fired[0]["detector"] == "cusum"
    assert fired[0]["direction"] == "up" and fired[0]["t"] > 40.0
    assert zfired == []
    return dict(fired=fired, snap=mon.snapshot())


@case
def anomaly_cooldown_expiry_pages_again(st):
    mon = st.O.AnomalyMonitor(cooldown_s=10.0, detector_factory=lambda: [
        st.O.RobustZScoreDetector(window=32, z_threshold=6.0,
                                  min_samples=8)])
    fired = []
    for i, v in enumerate(_level_series()):
        fired += mon.observe("x", v, float(i))
    assert len(fired) == 2 and fired[1]["t"] == 50.0
    return dict(fired=fired)


@case
def idle_zero_series_first_activity_scores_sanely(st):
    mon = st.O.AnomalyMonitor(cooldown_s=1000.0)
    fired = []
    for i in range(60):
        fired += mon.observe("queue_depth", 0.0, float(i))
    assert fired == []
    for i in range(60, 120):
        fired += mon.observe("queue_depth", 3.0 + 0.1 * (i % 4), float(i))
    assert all(f["detector"] != "zscore" for f in fired)
    assert all(abs(f["score"]) < 1e3 for f in fired)
    mon2 = st.O.AnomalyMonitor(cooldown_s=1000.0)
    for i in range(60):
        mon2.observe("busy", 3.0 + 0.1 * (i % 4), float(i))
    later = []
    for i in range(60, 80):
        later += mon2.observe("busy", 30.0, float(i))
    assert len(later) >= 1
    return dict(fired=fired, later=later)


@case
def spec_acceptance_reader_uses_snapshot_ratio(st):
    class _Spec:
        def snapshot(self):
            return {"acceptance_ratio": 0.42, "drafted": 100}

    class _Eng:
        spec = _Spec()

    out = (st.SG._spec_acceptance(_Eng()), st.SG._spec_acceptance(object()))
    assert out == (pytest.approx(0.42), 1.0)
    return dict(out=out)


@case
def anomaly_detection_byte_deterministic(st):
    def run():
        mon = st.O.AnomalyMonitor(cooldown_s=25.0)
        out = []
        for i, v in enumerate(_level_series() + _drift_series()):
            out += mon.observe("s", v, float(i) * 0.5)
        return json.dumps(out, sort_keys=True)
    first = run()
    assert first == run()
    return dict(doc=first)


@case
def anomaly_metrics_registered(st):
    mon = st.O.AnomalyMonitor(cooldown_s=1000.0)
    for i, v in enumerate(_level_series()):
        mon.observe("det_series", v, float(i))
    reg = st.O.get_registry()
    c = reg.get("paddle_anomaly_events_total")
    total = sum(v for k, v in c.snapshot().items() if "det_series" in k)
    assert total >= 1
    score = reg.get("paddle_anomaly_score").value(series="det_series")
    assert score >= 0.0
    return dict(total=total, score=score)


@case
def goodput_tracker_breakdown_math(st):
    t = st.O.GoodputTracker()
    t.note("productive", 8.0)
    t.note("retry", 1.0)
    t.note("checkpoint_stall", 0.5)
    out = t.finalize(10.0)
    assert out["untracked_s"] == pytest.approx(0.5)
    assert out["goodput_ratio"] == pytest.approx(0.8)
    assert sum(v for k, v in out.items()
               if k.endswith("_s") and k != "total_s") == pytest.approx(
        out["total_s"])
    with pytest.raises(KeyError):
        t.note("nonsense", 1.0)
    ratio = st.O.get_registry().get("paddle_goodput_ratio").value()
    assert ratio == pytest.approx(0.8)
    return dict(out=out, ratio=ratio)


@case
def straggler_detector_mad_zscore(st):
    det = st.O.StragglerDetector(window=16, z_threshold=4.0, min_samples=8)
    c = st.O.get_registry().get("paddle_stragglers_total")
    before = c.value(source="unit")
    zs = [det.observe(0.100, source="unit") for _ in range(12)]
    assert all(z <= 4.0 for z in zs)
    z = det.observe(0.500, source="unit")
    assert z > 4.0 and det.flagged == 1
    z3 = det.observe(0.101, source="unit")
    assert z3 < 4.0
    assert c.value(source="unit") - before == 1
    return dict(zs=zs + [z, z3])


# ---------------------------------------------------------------------------
# the signal bus through serving, /varz, history.json
# ---------------------------------------------------------------------------

@case
def signal_bus_serving_e2e(st):
    clk = FakeClock()
    params, eng, sched = _setup_serving(st, clock=clk, max_queue_depth=8)
    bus = sched.attach_signal_bus(interval_s=1.0, window_s=60.0)
    assert sched.signal_bus is bus
    bus.arm()
    try:
        assert st.TS.history_armed[0]
        for i in range(6):
            sched.submit(np.array([2, 3, 4, 5], np.int32), priority=i % 2)
        while sched.pending:
            clk.advance(1.5)
            sched.step(params)
        v = bus.values()
        for name in ("queue_depth", "page_pressure", "slo_burn",
                     "spec_acceptance", "queue_wait_share"):
            assert name in v, sorted(v)
        assert v["queue_depth"]["value"] is not None
        assert 0.0 <= v["page_pressure"]["raw"] <= 1.0
        assert bus.ticks >= 3
        assert bus.history.latest("tokens_total") > 0
        assert "signals" in sched.statusz()
        doc = bus.varz()
        assert doc["armed"] and "anomalies" in doc and "history" in doc
        contract = bus.snapshot_contract().as_dict()
    finally:
        bus.disarm()
    assert not st.TS.history_armed[0]
    return dict(values=v, varz=doc, ticks=bus.ticks, contract=contract)


@case
def signal_bus_disarmed_never_ticks(st):
    clk = FakeClock()
    params, eng, sched = _setup_serving(st, clock=clk)
    bus = sched.attach_signal_bus(interval_s=0.0)
    assert not st.TS.history_armed[0]
    sched.submit(np.array([2, 3, 4], np.int32))
    while sched.pending:
        clk.advance(1.0)
        sched.step(params)
    assert bus.ticks == 0
    return dict(ticks=bus.ticks)


def _ramp_bus(st):
    clk = FakeClock()
    bus = st.O.SignalBus(clock=clk, interval_s=1.0)
    depth = [3.0]
    bus.signal("queue_depth", lambda: depth[0])
    bus.arm()
    for i in range(10):
        clk.advance(1.0)
        depth[0] = 3.0 + i
        bus.tick()
    return bus


@case
def varz_endpoint_e2e(st):
    bus = _ramp_bus(st)
    srv = st.O.DiagServer(port=0)
    srv.attach_signals(bus)
    port = srv.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/varz")
        doc = json.loads(body)
        assert status == 200
        assert doc["signals"]["queue_depth"]["value"] is not None
        assert doc["signals"]["queue_depth"]["trend_per_s"] > 0
        assert doc["armed"] is True
        _, index = _get(f"http://127.0.0.1:{port}/")
        assert "/varz" in json.loads(index)["endpoints"]
        _, statusz = _get(f"http://127.0.0.1:{port}/statusz")
        assert "signals" in json.loads(statusz)
    finally:
        srv.stop()
        bus.disarm()
    return dict(varz=doc, index=json.loads(index))


@case
def varz_404_without_bus(st):
    srv = st.O.DiagServer(port=0)
    port = srv.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/varz")
    finally:
        srv.stop()
    assert status == 404
    return dict(status=status, body=body)


@case
def flight_bundle_embeds_history_json(st):
    import os
    import tempfile
    clk = FakeClock()
    bus = st.O.SignalBus(clock=clk, interval_s=1.0, capacity=128)
    val = [1.0]
    bus.signal("sig", lambda: val[0])
    bus.arm()
    for v in _level_series():
        clk.advance(1.0)
        val[0] = v
        bus.tick()
    fr = st.O.flight_recorder
    with tempfile.TemporaryDirectory() as tmp:
        fr.arm(capacity=64, dump_dir=tmp)
        path = fr.dump_debug_bundle(os.path.join(tmp, "bundle.tar.gz"),
                                    reason="test")
        assert os.path.getsize(path) < 256 * 1024
        with tarfile.open(path) as tar:
            assert "history.json" in tar.getnames()
            doc = json.loads(tar.extractfile("history.json").read())
    _reset(st)
    assert doc["schema_version"] == 1
    assert doc["kind"] == "paddle_tpu.history"
    assert len(doc["series"]["sig"]["points"]) <= 128
    assert doc["signals"]["sig"]["value"] is not None
    assert any(a["series"] == "sig" for a in doc["anomalies"])
    return dict(doc=doc)


# ---------------------------------------------------------------------------
# DiagServer routes (tests/test_slo_diag.py)
# ---------------------------------------------------------------------------

@case
def metrics_endpoint_byte_identical(st):
    reg = st.O.MetricsRegistry()
    reg.counter("a_total", "a", labels=("k",)).inc(k="v")
    reg.gauge("b").set(1.5)
    reg.histogram("c_ms").observe(3.0)
    srv = st.O.DiagServer(registry=reg)
    port = srv.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/metrics")
    finally:
        srv.stop()
    assert status == 200 and body == reg.prometheus_text().encode("utf-8")
    return dict(body=body)


@case
def statusz_aggregates_providers(st):
    params, eng, sched = _setup_serving(st)
    sched.submit(np.array([1, 2, 3], np.int32))
    while sched.pending:
        sched.step(params)
    tracker = st.O.GoodputTracker()
    tracker.note("productive", 1.0)
    tracker.finalize(1.25)
    srv = st.O.DiagServer()
    srv.attach_scheduler(sched)
    srv.attach_goodput(tracker)
    port = srv.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/statusz")
        doc = json.loads(body)
        assert status == 200 and doc["health"] == "ok"
        s = doc["serving"]
        assert s["queued"] == 0 and s["inflight"] == 0
        assert s["slots"]["total"] == 2 and s["pages"]["usable"] > 0
        assert s["counters"]["requests_completed_total"] == 1
        assert doc["goodput"]["goodput_ratio"] == 0.8
        assert doc["flight_recorder"]["armed"] is False
        status2, _ = _get(f"http://127.0.0.1:{port}/statusz/")
        assert status2 == 200
    finally:
        srv.stop()
    return dict(goodput=doc["goodput"], slots=s["slots"], pages=s["pages"],
                counters=s["counters"], keys=sorted(doc))


@case
def statusz_includes_kvcache_provider(st):
    params, eng, sched = _setup_serving(st, prefix_cache=True)
    sched.submit(np.array([1, 2, 3, 4, 5], np.int32))
    while sched.pending:
        sched.step(params)
    srv = st.O.DiagServer()
    srv.attach_kvcache(eng.cache)
    port = srv.start()
    try:
        _, body = _get(f"http://127.0.0.1:{port}/statusz")
    finally:
        srv.stop()
    kv = json.loads(body)["kvcache"]
    assert {"hits", "misses", "pages"} <= set(kv)
    assert kv["pages"]["usable"] > 0 and kv["pages"]["cached"] >= 1
    return dict(kv=kv)


@case
def unknown_route_404_and_health_composes_degraded(st):
    srv = st.O.DiagServer()
    srv.add_health_source("custom", lambda: "degraded")
    port = srv.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        missing = _get(f"http://127.0.0.1:{port}/nope")
    finally:
        srv.stop()
    assert status == 200 and json.loads(body)["status"] == "degraded"
    assert missing[0] == 404
    return dict(health=(status, body), missing=missing)


@case
def debugz_dump_endpoint(st):
    import tempfile
    from pathlib import Path
    fr = st.O.flight_recorder
    with tempfile.TemporaryDirectory() as tmp:
        fr.clear()
        fr.arm(capacity=8, dump_dir=tmp)
        st.EV.emit_event("before_dump", n=1)
        srv = st.O.DiagServer()
        port = srv.start()
        try:
            _, body = _get(f"http://127.0.0.1:{port}/debugz")
            status = json.loads(body)
            assert status["armed"] is True and status["events"] >= 1
            _, body = _get(f"http://127.0.0.1:{port}/debugz?dump=1")
            dumped = json.loads(body)["dumped"]
            assert Path(dumped).exists()
            with tarfile.open(dumped) as tar:
                names = sorted(tar.getnames())
                events = [json.loads(line) for line in tar.extractfile(
                    "events.jsonl").read().splitlines()]
        finally:
            srv.stop()
            _reset(st)
    assert any(e["kind"] == "before_dump" for e in events)
    return dict(keys=sorted(status), names=names,
                kinds=[e["kind"] for e in events])


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax_stack(name, clean_plane):
    for st in STACKS.values():
        _reset(st)
    want = CASES[name](STACKS["jax"])
    _reset(STACKS["jax"])
    got = CASES[name](STACKS["torch"])
    _reset(STACKS["torch"])
    assert got == want


# ---------------------------------------------------------------------------
# the catalog, and every DiagServer route over one fleet
# ---------------------------------------------------------------------------

def test_catalog_declares_the_reference_entries():
    assert TCAT.METRICS == JCAT.METRICS
    assert TCAT.EVENT_KINDS == JCAT.EVENT_KINDS
    assert TCAT.SPANS == JCAT.SPANS
    for name in TCAT.METRICS:
        assert TCAT.declared_metric(name) == JCAT.declared_metric(name)


ROUTES = ("/", "/metrics", "/healthz", "/statusz", "/tracez", "/varz",
          "/scalez", "/journalz", "/memz", "/debugz")


def _fleet_server(st):
    """A two-replica disaggregated fleet on a fake clock with its
    router, signal bus and autoscaler attached to one DiagServer."""
    from test_torch_autoscale import STACKS as AS_STACKS, disagg_fleet
    ast = AS_STACKS[st.name]
    R = ast.SV.ReplicaRole
    env = disagg_fleet(ast, n=2, roles={0: R.PREFILL, 1: R.DECODE})
    ctl = ast.SV.AutoscaleController(env.router, env.make_engine,
                                     env.make_handle, interval_s=0.1)
    env.router.submit(np.arange(3, 13, dtype=np.int32))
    for _ in range(30):
        if not env.router.pending:
            break
        ctl.step(env.params)
        env.clock.advance(0.05)
    srv = st.O.DiagServer(port=0, monitor=env.router.make_slo_monitor())
    srv.attach_router(env.router)
    srv.attach_signals(ctl.bus)
    srv.attach_autoscale(ctl)
    sched = env.replicas[0]
    srv.attach_kvcache(env.engines[1].cache)
    return srv, env, ctl, sched


def test_every_route_answers_with_the_reference_keys(clean_plane):
    """GET every route of a fleet-attached DiagServer in both stacks:
    each answers 200 with the same top-level keys; /scalez and /varz
    carry equal documents (same fleet, same clock), and
    ``attach_federation`` mounts the fleet view on /statusz as the
    reference's does."""
    docs = {}
    for name, st in STACKS.items():
        srv, env, ctl, _ = _fleet_server(st)
        port = srv.start()
        try:
            out = {}
            for route in ROUTES:
                status, body = _get(f"http://127.0.0.1:{port}{route}")
                assert status == 200, (name, route, body[:200])
                out[route] = (body.decode() if route == "/metrics"
                              else json.loads(body))
        finally:
            srv.stop()
            _reset(st)
        docs[name] = out
    j, t = docs["jax"], docs["torch"]
    for route in ROUTES:
        if route != "/metrics":
            assert sorted(t[route]) == sorted(j[route]), route
    assert t["/scalez"] == j["/scalez"]
    assert t["/varz"]["signals"] == j["/varz"]["signals"]
    assert t["/statusz"]["router"]["roles"] == {"0": "prefill",
                                               "1": "decode"}
    for fam in ("paddle_router_requests_total", "paddle_handoff_pages_total",
                "paddle_router_replica_role", "paddle_signal_value"):
        assert f"# TYPE {fam}" in t["/metrics"]
    views = {}
    for name, O in (("jax", JO), ("torch", TO)):
        srv = O.DiagServer()
        srv.attach_federation(O.FederationHub())
        views[name] = srv.statusz()["federation"]
    assert views["torch"] == views["jax"]
    assert set(views["torch"]) == {"armed", "reconcile_error_ms", "hosts"}
