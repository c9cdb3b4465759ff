"""Telemetry federation: ``paddle_tpu_torch.observability.federation``
against ``paddle_tpu.observability.federation``.

Every scenario of the JAX package's ``tests/test_federation.py`` runs
through both stacks on the same inputs: the unit scenarios on
fabricated frames (hermetic registries and collectors, synthetic clock
offsets), the fleet scenarios over ``LocalTransport`` on a fake clock
(``test_torch_multihost``'s fleets: tiny widths, the same JAX-made
weights). Both stacks must agree on the clock estimates, the merged
exposition text byte for byte, span merges, mirror snapshots, signal
values, bundle members and statusz shapes. ``DiagServer.
attach_federation`` serves the merged document at ``/metrics``."""

import json
import os
import tarfile
import urllib.request
from types import SimpleNamespace

import pytest

import paddle_tpu.observability.federation as JF
import paddle_tpu.observability.flight as JFL
import paddle_tpu.observability.format as JFMT
import paddle_tpu.observability.registry as JR
import paddle_tpu.observability.server as JSRV
import paddle_tpu.observability.signals as JSIG
import paddle_tpu.observability.timeline as JT
import paddle_tpu.profiler.record as JREC
import paddle_tpu_torch.observability.federation as TF
import paddle_tpu_torch.observability.flight as TFL
import paddle_tpu_torch.observability.format as TFMT
import paddle_tpu_torch.observability.registry as TR
import paddle_tpu_torch.observability.server as TSRV
import paddle_tpu_torch.observability.signals as TSIG
import paddle_tpu_torch.observability.timeline as TT
import paddle_tpu_torch.profiler.record as TREC
from paddle_tpu_torch.testing import one_cpu_thread
from test_torch_multihost import (STACKS, FakeClock, _quiet, local_fleet,
                                  prompt)

one_cpu_thread()

FED = {
    "jax": SimpleNamespace(F=JF, FL=JFL, FMT=JFMT, R=JR, SRV=JSRV, SIG=JSIG,
                           T=JT, REC=JREC, **vars(STACKS["jax"])),
    "torch": SimpleNamespace(F=TF, FL=TFL, FMT=TFMT, R=TR, SRV=TSRV,
                             SIG=TSIG, T=TT, REC=TREC,
                             **vars(STACKS["torch"])),
}

#: a pid that is never this process (frames from "real" remote hosts)
OTHER_PID = os.getpid() + 1


def _frame(host_id, seq, spans=(), pid=OTHER_PID, t_ns=None, gauges=None,
           metrics_text="", signals=None):
    return {"host_id": host_id, "pid": pid, "seq": seq,
            "t_ns": 0 if t_ns is None else t_ns,
            "metrics_text": metrics_text, "gauges": dict(gauges or {}),
            "signals": dict(signals or {}), "events": [], "memory": {},
            "spans": list(spans)}


def _span(name, start_ns, end_ns, trace_id="tr", args=None):
    return {"name": name, "event_type": "UserDefined",
            "start_ns": int(start_ns), "end_ns": int(end_ns),
            "trace_id": trace_id, "args": args}


def _hub(st, **kw):
    kw.setdefault("registry", st.R.MetricsRegistry())
    kw.setdefault("collector", st.T.SpanCollector())
    return st.F.FederationHub(**kw)


def _spans(coll, trace="tr"):
    return [(s.name, s.start_ns, s.end_ns, s.trace_id, s.args)
            for s in sorted(coll.spans(trace), key=lambda s: s.start_ns)]


def _mirror(m):
    """A mirror's document without its ingest time (the hub's monotonic
    clock)."""
    return dict(m.as_dict(), last_ingest_t=None)


def _exposition(st, value):
    reg = st.R.MetricsRegistry()
    reg.counter("x_total", "x").inc(value)
    reg.gauge("y_gauge", "y", labels=("k",)).set(value, k="a")
    return reg.prometheus_text()


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# ClockSync
# ---------------------------------------------------------------------------

@scenario
def clocksync_estimates_offset_from_midpoint(st, tmp):
    cs = st.F.ClockSync()
    cs.observe(t_send_ns=1_000_000, t_recv_ns=3_000_000,
               t_remote_ns=2_000_000 + 5_000_000)
    assert cs.offset_ns == pytest.approx(5_000_000)
    assert cs.error_bound_ns == pytest.approx(1_000_000)
    assert cs.correct(10_000_000 + 5_000_000) == pytest.approx(10_000_000)
    return {"snap": cs.snapshot(), "corr": cs.correct(15_000_000)}


@scenario
def clocksync_ewma_converges_and_discards_negative_rtt(st, tmp):
    cs = st.F.ClockSync(alpha=0.5)
    for i in range(20):
        base = i * 10_000_000
        cs.observe(base, base + 2_000_000, base + 1_000_000 + 7_000_000)
    assert cs.offset_ns == pytest.approx(7_000_000, rel=1e-6)
    n = cs.samples
    cs.observe(5_000_000, 4_000_000, 0)
    assert cs.samples == n
    snap = cs.snapshot()
    assert snap["offset_ms"] == pytest.approx(7.0, rel=1e-6)
    assert snap["rtt_p50_ms"] == pytest.approx(2.0, rel=1e-6)
    return {"snap": snap, "offset": cs.offset_ns}


@scenario
def clocksync_rtt_quantiles_over_window(st, tmp):
    cs = st.F.ClockSync()
    for ms in range(1, 11):
        cs.observe(0, ms * 1_000_000, ms * 500_000)
    assert cs.rtt_quantile(0.5) == pytest.approx(6_000_000)
    assert cs.rtt_quantile(0.9) == pytest.approx(10_000_000)
    return {"q": [cs.rtt_quantile(q) for q in (0.0, 0.5, 0.9, 1.0)]}


# ---------------------------------------------------------------------------
# exposition merging
# ---------------------------------------------------------------------------

@scenario
def merge_expositions_byte_identical_and_valid(st, tmp):
    docs = {"parent": _exposition(st, 1), "h0": _exposition(st, 2),
            "h1": _exposition(st, 3)}
    merged = st.F.merge_expositions(docs)
    st.FMT.validate_exposition_text(merged)
    reordered = {"h1": docs["h1"], "parent": docs["parent"],
                 "h0": docs["h0"]}
    assert st.F.merge_expositions(reordered) == merged
    assert 'x_total{host="parent"} 1' in merged
    assert 'x_total{host="h0"} 2' in merged
    assert 'y_gauge{host="h1",k="a"} 3' in merged
    assert merged.count("# TYPE x_total counter") == 1
    return {"merged": merged}


@scenario
def merge_expositions_preserves_existing_host_label(st, tmp):
    doc = ('# TYPE paddle_host_state gauge\n'
           'paddle_host_state{host="0"} 2\n')
    merged = st.F.merge_expositions({"parent": doc})
    st.FMT.validate_exposition_text(merged)
    assert 'paddle_host_state{host="0"} 2' in merged
    assert 'host="parent"' not in merged
    return {"merged": merged}


@scenario
def merged_histograms_stay_cumulative_per_host(st, tmp):
    def doc(n):
        reg = st.R.MetricsRegistry()
        h = reg.histogram("z_seconds", "z", bounds=(1.0, 2.0),
                          quantiles=None)
        for _ in range(n):
            h.observe(1.5)
        return reg.prometheus_text()
    merged = st.F.merge_expositions({"h0": doc(1), "h1": doc(3)})
    st.FMT.validate_exposition_text(merged)
    assert 'z_seconds_bucket{host="h0",le="2"} 1' in merged
    assert 'z_seconds_bucket{host="h1",le="2"} 3' in merged
    return {"merged": merged}


# ---------------------------------------------------------------------------
# FederationHub
# ---------------------------------------------------------------------------

@scenario
def ingest_merges_remote_spans_skew_corrected(st, tmp):
    st.T.timeline_armed[0] = True
    hub = _hub(st)
    offset = 5_000_000_000
    hub.observe_rtt(7, 1_000_000, 3_000_000, 2_000_000 + offset)
    spans = [_span("engine.prefill", offset + 100, offset + 200),
             _span("engine.decode_chunk", offset + 300, offset + 400)]
    merged = hub.ingest(7, _frame(7, seq=0, spans=spans))
    assert merged == 2
    got = sorted(hub._collector.spans("tr"), key=lambda s: s.start_ns)
    assert [s.start_ns for s in got] == [100, 300]
    assert [s.end_ns for s in got] == [200, 400]
    assert all(s.args["host"] == 7 for s in got)
    m = hub.mirror(7)
    assert m.frames == 1 and m.spans_merged == 2 and not m.stale
    return {"spans": _spans(hub._collector), "mirror": _mirror(m)}


@scenario
def skew_correction_restores_cross_host_ordering(st, tmp):
    st.T.timeline_armed[0] = True
    hub = _hub(st)
    offsets = {0: 3_000_000_000, 1: -2_000_000_000}
    rtt = 2_000_000
    for hid, off in offsets.items():
        for k in range(8):
            base = k * 10_000_000
            hub.observe_rtt(hid, base, base + rtt, base + rtt // 2 + off)
    truth = [(1_000, 0), (2_000, 1), (3_000, 0), (4_000, 1), (5_000, 0)]
    for seq, (t, hid) in enumerate(truth):
        sp = _span("engine.decode_chunk", offsets[hid] + t,
                   offsets[hid] + t + 500)
        assert hub.ingest(hid, _frame(hid, seq=seq, spans=[sp])) == 1
    got = sorted(hub._collector.spans("tr"), key=lambda s: s.start_ns)
    assert [s.args["host"] for s in got] == [h for _, h in truth]
    bound = max(m.clock.error_bound_ns for m in hub._live_mirrors())
    assert hub.reconcile_error_s() == pytest.approx(bound / 1e9)
    for s, (t, _) in zip(got, truth):
        assert abs(s.start_ns - t) <= bound
    assert bound == pytest.approx(rtt / 2)
    return {"spans": _spans(hub._collector),
            "reconcile": hub.reconcile_error_s()}


@scenario
def trace_tree_merge_is_deterministic(st, tmp):
    st.T.timeline_armed[0] = True
    frames = []
    for seq in range(3):
        spans = [_span("paddle_host_h0.request", 1_000, 9_000),
                 _span("engine.prefill", 2_000 + seq, 4_000 + seq)]
        frames.append(_frame(0, seq=seq, spans=spans))
    trees = []
    for _ in range(2):
        hub = _hub(st)
        for fr in frames:
            hub.ingest(0, dict(fr))
        trees.append(json.dumps(hub._collector.tree("tr"), sort_keys=True))
    assert trees[0] == trees[1]
    return {"tree": trees[0]}


@scenario
def ingest_dedupes_stale_seq_and_freezes_lost(st, tmp):
    st.T.timeline_armed[0] = True
    hub = _hub(st)
    assert hub.ingest(3, _frame(3, seq=5)) == 0
    assert hub.mirror(3).seq == 5
    sp = [_span("step", 1, 2)]
    assert hub.ingest(3, _frame(3, seq=5, spans=sp)) == 0
    assert hub.mirror(3).frames == 1
    hub.mark_lost(3)
    assert hub.ingest(3, _frame(3, seq=9, spans=sp)) == 0
    m = hub.mirror(3)
    assert m.lost and m.stale and m.seq == 5
    return {"mirror": _mirror(m)}


@scenario
def same_process_frames_skip_span_injection(st, tmp):
    st.T.timeline_armed[0] = True
    hub = _hub(st)
    fr = _frame(0, seq=0, pid=os.getpid(), spans=[_span("step", 1, 2)])
    assert hub.ingest(0, fr) == 0
    assert hub.mirror(0).frames == 1
    assert hub._collector.spans("tr") == []
    return {"mirror": _mirror(hub.mirror(0))}


@scenario
def mark_stale_keeps_last_frame_and_counts_gauge(st, tmp):
    reg = st.R.MetricsRegistry()
    hub = _hub(st, registry=reg)
    hub.ingest(2, _frame(2, seq=0, gauges={"queue_depth": 4.0}))
    hub.mark_stale(2, "HostFault('no reply')")
    m = hub.mirror(2)
    assert m.stale and m.frame["gauges"]["queue_depth"] == 4.0
    assert m.stale_error == "HostFault('no reply')"
    stale = reg.get("paddle_federation_stale_mirrors").value()
    assert stale == 1.0
    hub.ingest(2, _frame(2, seq=1))
    assert not hub.mirror(2).stale
    assert reg.get("paddle_federation_stale_mirrors").value() == 0.0
    return {"text": reg.prometheus_text()}


@scenario
def federated_metrics_text_is_one_valid_doc(st, tmp):
    hub = _hub(st)
    hub.ingest(0, _frame(0, seq=0, metrics_text=_exposition(st, 2)))
    hub.ingest(1, _frame(1, seq=0, metrics_text=_exposition(st, 5)))
    hub.ingest(2, _frame(2, seq=0, pid=os.getpid(),
                         metrics_text=_exposition(st, 9)))
    text = hub.federated_metrics_text()
    st.FMT.validate_exposition_text(text)
    assert 'x_total{host="h0"} 2' in text
    assert 'x_total{host="h1"} 5' in text
    assert 'x_total{host="h2"} 9' not in text
    assert 'paddle_federation_frames_total{host="h0"} 1' in text
    assert 'paddle_federation_stale_mirrors{host="parent"}' in text
    return {"text": text}


@scenario
def fleet_signals_aggregate_mirrors(st, tmp):
    hub = _hub(st)
    for hid, (depth, util) in {0: (3.0, 0.5), 1: (5.0, 0.9)}.items():
        hub.observe_rtt(hid, 0, 4_000_000, 2_000_000)
        hub.ingest(hid, _frame(
            hid, seq=0,
            gauges={"queue_depth": depth, "page_utilization": util},
            signals={"serving.slo_burn": {"value": 0.25 * (hid + 1)}}))
    clock = FakeClock()
    bus = st.SIG.SignalBus(clock=clock, interval_s=0.0)
    hub.attach_fleet_signals(bus)
    bus.arm()
    try:
        clock.advance(1.0)
        bus.tick(clock())
        vals = bus.values()
    finally:
        bus.disarm()
    assert vals["fleet.queue_depth"]["raw"] == pytest.approx(8.0)
    assert vals["fleet.pool_pressure"]["raw"] == pytest.approx(0.9)
    assert vals["fleet.burn_rate"]["raw"] == pytest.approx(0.5)
    assert vals["host_rtt_p90"]["raw"] == pytest.approx(0.004)
    assert vals["h0.queue_depth"]["raw"] == pytest.approx(3.0)
    assert vals["h1.rtt_ms"]["raw"] == pytest.approx(4.0)
    return {"values": {k: v["raw"] for k, v in sorted(vals.items())}}


@scenario
def snapshot_and_fleet_varz_shapes(st, tmp):
    hub = _hub(st)
    hub.ingest(0, _frame(0, seq=2))
    hub.mark_lost(1)
    snap = hub.snapshot()
    assert snap["kind"] == "paddle_tpu.host_telemetry"
    assert snap["hosts"]["h0"]["seq"] == 2
    assert snap["hosts"]["h1"]["lost"]
    json.dumps(snap)
    fv = hub.fleet_varz()
    assert set(fv) == {"armed", "reconcile_error_ms", "hosts"}
    assert fv["hosts"]["h0"]["frames"] == 1
    for h in snap["hosts"].values():
        h["last_ingest_t"] = None       # the hub's monotonic clock
    return {"snap": snap, "varz": fv}


@scenario
def collect_telemetry_frame_shape(st, tmp):
    reg = st.R.MetricsRegistry()
    reg.counter("x_total", "x").inc()
    coll = st.T.SpanCollector()
    st.T.timeline_armed[0] = True
    coll.note_span(st.REC.HostSpan("engine.prefill", "UserDefined", 1, 2,
                                   0, os.getpid(), "tr", None))
    marks = {}
    fr = st.F.collect_telemetry(4, marks, seq=0, registry=reg,
                                collector=coll)
    assert fr["host_id"] == 4 and fr["pid"] == os.getpid()
    assert "x_total" in fr["metrics_text"]
    assert [s["name"] for s in fr["spans"]] == ["engine.prefill"]
    fr2 = st.F.collect_telemetry(4, marks, seq=1, registry=reg,
                                 collector=coll)
    assert fr2["spans"] == []
    return {"frame": dict(fr, t_ns=None), "keys": sorted(fr2),
            "marks": marks}


# ---------------------------------------------------------------------------
# fleet integration over LocalTransport
# ---------------------------------------------------------------------------

def _fleet(st, n=2, max_new=8, health_kw=None):
    router, clock, hosts, _ = local_fleet(st, n=n, max_new=max_new,
                                          health_kw=health_kw)
    return router, clock, hosts


@scenario
def beats_populate_mirrors_and_rtt_histogram(st, tmp):
    router, clock, hosts = _fleet(st, n=2)
    hist = st.O.get_registry().get("paddle_host_heartbeat_rtt_seconds")
    c0 = hist.hist(host="h0").count
    router.federation.arm()
    try:
        h = router.submit(prompt(), max_new_tokens=6)
        for _ in range(4):
            router.step(None)
            clock.advance(0.05)
        frames = {}
        for hid in (0, 1):
            m = router.federation.mirror(hid)
            assert m.frames >= 4 and not m.stale
            assert m.frame["gauges"].keys() >= {"queue_depth", "inflight"}
            assert f"paddle_host_h{hid}" in m.frame["metrics_text"]
            frames[hid] = (m.frames, m.seq, sorted(m.frame["gauges"]))
        beats = hist.hist(host="h0").count - c0
        assert beats >= 4
        while router.pending:
            router.step(None)
            clock.advance(0.05)
        assert h.state == "done"
    finally:
        router.federation.disarm()
    return {"tokens": list(h.stream.tokens), "frames": frames,
            "beats": beats}


@scenario
def disarmed_federation_does_no_telemetry_rpcs(st, tmp):
    router, clock, hosts = _fleet(st, n=1)
    router.submit(prompt(), max_new_tokens=6)
    calls0 = hosts[0].endpoint.calls
    steps = 0
    while router.pending:
        router.step(None)
        clock.advance(0.05)
        steps += 1
    assert hosts[0].endpoint.calls - calls0 == steps
    return {"steps": steps}


@scenario
def statusz_failure_marks_view_stale_with_counter(st, tmp):
    router, clock, hosts = _fleet(st, n=2)
    c = st.O.get_registry().get("paddle_host_statusz_errors_total")
    e0 = c.value(host="h0")
    s1 = hosts[0].statusz()
    assert s1["host"]["host_id"] == 0 and s1["host"]["stale"] is False
    t_ok = clock()
    clock.advance(5.0)
    hosts[0].kill()
    s2 = hosts[0].statusz()
    assert s2["host"]["stale"] is True
    assert s2["host"]["host_id"] == 0
    assert "HostFault" in s2["host"]["stale_error"]
    assert s2["host"]["last_success_t"] == t_ok
    assert c.value(host="h0") - e0 == 1.0
    for s in (s1, s2):
        s["transport"] = None           # frame byte counts per stack
    return {"fresh": s1, "stale": dict(s2, host=dict(
        s2["host"], stale_error=None))}


@scenario
def dead_host_bundle_embeds_last_telemetry_mirror(st, tmp):
    fr = st.O.flight_recorder
    dump = tmp / st.name
    dump.mkdir()
    fr.clear()
    fr.arm(dump_dir=str(dump))
    router, clock, hosts = _fleet(st, n=2,
                                  health_kw={"probe_cooldown_s": 1e9})
    router.federation.arm()
    try:
        h = router.submit(prompt(), max_new_tokens=8)
        for _ in range(3):
            router.step(None)
            clock.advance(0.05)
        victim = h.replica_id
        pre_kill_seq = router.federation.mirror(victim).seq
        assert pre_kill_seq >= 0
        hosts[victim].kill()
        steps = 0
        while router.pending:
            router.step(None)
            clock.advance(0.05)
            steps += 1
            assert steps < 500
        assert h.state == "done"
        m = router.federation.mirror(victim)
        assert m.lost and m.seq == pre_kill_seq
        bundles = list(dump.glob(f"paddle_debug_replica_ejected_{victim}*"))
        assert bundles, list(dump.iterdir())
        with tarfile.open(bundles[0]) as tf:
            tel = json.loads(tf.extractfile("host_telemetry.json").read())
        dead = tel["hosts"][f"h{victim}"]
        assert dead["lost"] and dead["seq"] == pre_kill_seq
        assert dead["frame"]["gauges"]["inflight"] >= 1
        assert f"paddle_host_h{victim}" in dead["frame"]["metrics_text"]
    finally:
        router.federation.disarm()
        fr.disarm()
        fr.clear()
    return {"tokens": list(h.stream.tokens), "victim": victim,
            "seq": pre_kill_seq, "gauges": dead["frame"]["gauges"],
            "lost": dead["lost"]}


@scenario
def migration_grows_segments_that_tile_the_envelope(st, tmp):
    st.T.timeline_armed[0] = True
    router, clock, hosts = _fleet(st, n=2, max_new=12)
    router.federation.arm()
    try:
        h = router.submit(prompt(), max_new_tokens=12)
        for _ in range(4):
            router.step(None)
            clock.advance(0.05)
        assert not h.done
        summary = router.migrate_host(h.replica_id)
        assert summary["requests"] == 1
        steps = 0
        while router.pending:
            router.step(None)
            clock.advance(0.05)
            steps += 1
            assert steps < 500
        att = st.T.span_collector.attribute(h.trace_id)
        segs = att["segments"]
        assert segs.get("migration", 0) > 0
        assert segs.get("dcn_transfer", 0) > 0
        assert sum(segs.values()) == pytest.approx(att["e2e_ms"], rel=1e-6)
    finally:
        router.federation.disarm()
    return {"tokens": list(h.stream.tokens), "segments": sorted(segs)}


@pytest.fixture
def disarmed():
    for st in FED.values():
        _quiet(st)
    yield
    for st in FED.values():
        st.T.timeline_armed[0] = False
        _quiet(st)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_stack(name, disarmed, tmp_path):
    want = SCENARIOS[name](FED["jax"], tmp_path)
    FED["jax"].T.timeline_armed[0] = False
    got = SCENARIOS[name](FED["torch"], tmp_path)
    assert got == want


# ---------------------------------------------------------------------------
# the diagnostics server's federated /metrics
# ---------------------------------------------------------------------------

def test_diag_server_serves_one_merged_document(disarmed):
    """``attach_federation``: /metrics is the hub's merged document
    (byte-equal to the reference's for the same frames), validator-clean
    with a ``host`` label per mirror, and /statusz carries the fleet
    view."""
    bodies = {}
    for st in FED.values():
        reg = st.R.MetricsRegistry()
        hub = _hub(st, registry=reg)
        for hid in (0, 1):
            hub.ingest(hid, _frame(hid, seq=0,
                                   metrics_text=_exposition(st, hid + 2)))
        srv = st.SRV.DiagServer(registry=reg)
        srv.attach_federation(hub)
        srv.start()
        try:
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=10) as r:
                text = r.read().decode()
            with urllib.request.urlopen(srv.url + "/statusz",
                                        timeout=10) as r:
                status = json.loads(r.read())
        finally:
            srv.stop()
        st.FMT.validate_exposition_text(text)
        assert text == hub.federated_metrics_text()
        assert 'x_total{host="h0"} 2' in text
        assert 'x_total{host="h1"} 3' in text
        assert set(status["federation"]["hosts"]) == {"h0", "h1"}
        bodies[st.name] = (text, status["federation"])
    assert bodies["torch"] == bodies["jax"]
