"""The port's observability modules and the engine's serving hooks
against the JAX package's, on the same inputs.

Host modules (``core.histogram``, ``observability.format`` /
``registry`` / ``trace`` / ``events`` / ``flight`` / ``journal`` /
``timeline`` / ``memory`` / ``slo`` / ``runtime``) are fed the same
values in both packages and must give the same outputs. The engine-side
taps (span windows, memory feed, miss records, the ``paddle_sampling_*``
/ ``paddle_spec_*`` / ``paddle_kvcache_*`` families, callbacks, ``_oom``)
are compared over the same serves of the JAX engine and the port's CPU
engine on the same ``llama_tiny`` weights."""

import importlib
import itertools
import json
import tarfile
from collections import Counter as Multiset

import numpy as np
import pytest

import paddle_tpu.core.histogram as JH
import paddle_tpu.observability as JO
import paddle_tpu.observability.flight as JFL
import paddle_tpu.observability.memory as JM
import paddle_tpu.observability.timeline as JT
import paddle_tpu.profiler.record as JREC
import paddle_tpu.serving as JSV
import paddle_tpu_torch.core.histogram as TH
import paddle_tpu_torch.observability as TO
import paddle_tpu_torch.observability.flight as TFL
import paddle_tpu_torch.observability.memory as TM
import paddle_tpu_torch.observability.timeline as TT
import paddle_tpu_torch.profiler.record as TREC
import paddle_tpu_torch.serving as TSV
from paddle_tpu.inference import constrain as JC
from paddle_tpu.inference import decoding as JD
from paddle_tpu.inference.sampling import SamplerConfig as JSampler
from paddle_tpu.models import llama as JL
from paddle_tpu.ops.paged_attention import PagedKVCacheManager as JMgr
from paddle_tpu_torch.inference import constrain as TC
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference.sampling import SamplerConfig as TSampler
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.paged_attention import PagedKVCacheManager as TMgr
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# the packages export their ``journal`` recorder under the module's name
JJ = importlib.import_module("paddle_tpu.observability.journal")
TJ = importlib.import_module("paddle_tpu_torch.observability.journal")


def _weights(seed=3):
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    jp = JL.init_stacked_params(jcfg, seed=seed)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              cfg, "cpu")
    return jcfg, jp, cfg, tp


W = _weights()


def _pair(max_new=5, num_slots=2, chunk=2, page_size=4, max_seq_len=32,
          **kw):
    geo = dict(num_slots=num_slots, page_size=page_size,
               max_seq_len=max_seq_len, chunk=chunk, **kw)
    return (JD.ContinuousBatchingEngine(
                W[0], JD.GenerationConfig(max_new_tokens=max_new), **geo),
            TD.ContinuousBatchingEngine(
                W[2], TD.GenerationConfig(max_new_tokens=max_new),
                device="cpu", **geo))


def _prompts(n, seed=0, lens=(3, 12)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, (int(rng.randint(*lens)),)).astype(np.int32)
            for _ in range(n)]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# histograms, exposition format, registry
# ---------------------------------------------------------------------------

HIST_CASES = {
    "latency_ms": (None, np.random.RandomState(0).lognormal(2.0, 1.2, 500)),
    "small_ints": ((0, 1, 2, 4, 8, 16), np.arange(40) % 17),
    "capped_samples": ((1, 10, 100), np.linspace(0.0, 250.0, 3000)),
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_quantiles_and_buckets_equal(case):
    bounds, values = HIST_CASES[case]
    kw = {} if bounds is None else {"bounds": bounds}
    hj, ht = JH.Histogram(**kw), TH.Histogram(**kw)
    for v in values:
        hj.record(float(v))
        ht.record(float(v))
    assert ht.bucket_counts == hj.bucket_counts
    assert (ht.count, ht.sum, ht.min, ht.max) == (hj.count, hj.sum,
                                                  hj.min, hj.max)
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ht.percentile(q) == hj.percentile(q)
    assert ht.summary() == hj.summary()


def _drive_registry(O):
    reg = O.MetricsRegistry()
    c = reg.counter("unit_requests_total", "requests by route",
                    labels=("route", "code"))
    c.inc(route="/a", code=200)
    c.inc(3, route="/b", code=500)
    c.inc(route='/quote"and\\slash', code=200)
    g = reg.gauge("unit_depth", "queue depth")
    g.set(7)
    g.inc(-2)
    h = reg.histogram("unit_latency_ms", "latency", labels=("kind",),
                      bounds=(1, 5, 25, 125))
    for i, v in enumerate((0.5, 3, 3, 80, 400, 12.5)):
        h.observe(v, kind="prefill" if i % 2 else "decode")
    reg.register_sink("unit_sink", lambda: O.format.counter_lines(
        "unit_sink_total", series=[({"x": "1"}, 2.0)], help="sink"),
        lambda: {"sink": 2})
    return reg


def test_registry_prometheus_text_and_snapshot_equal():
    rj, rt = _drive_registry(JO), _drive_registry(TO)
    text = rt.prometheus_text()
    assert text == rj.prometheus_text()
    TO.format.validate_exposition_text(text)
    assert rt.snapshot() == rj.snapshot()
    hj, ht = JH.Histogram(bounds=(1, 2)), TH.Histogram(bounds=(1, 2))
    for h in (hj, ht):
        for v in (0.5, 1.5, 9):
            h.record(v)
    assert (TO.format.histogram_lines("m", ht, labels={"a": "b"})
            == JO.format.histogram_lines("m", hj, labels={"a": "b"}))


def test_serving_metrics_exposition_equal():
    def drive(SV):
        m = SV.ServingMetrics(namespace="paddle_serving_unit")
        for v in (3.0, 40.0, 900.0):
            m.observe("ttft_ms", v, trace_id=f"t{v}")
            m.observe("itl_ms", v / 3)
        m.inc("requests_submitted_total", 4)
        m.inc_shed("queue_full")
        m.set_gauge("queue_depth", 2)
        return m
    mj, mt = drive(JSV), drive(TSV)
    assert mt.to_prometheus_text() == mj.to_prometheus_text()
    assert mt.exemplars_snapshot() == mj.exemplars_snapshot()


# ---------------------------------------------------------------------------
# trace context, events, flight bundles, journal
# ---------------------------------------------------------------------------

def _event_lines(O, path):
    old = O.event_log.path
    O.configure_event_log(str(path))
    try:
        with O.trace_context(trace_id="req-7", request_id=7, step=3):
            assert O.current_trace_id() == "req-7"
            O.emit_event("shed", reason="queue_full", priority=2)
            with O.trace_context(step=4):
                O.emit_event("step_retry", attempt=1, backoff_s=0.05)
        O.emit_event("degraded", error=None, inflight=0)
    finally:
        O.configure_event_log(old)
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("ts")
        out.append(rec)
    return out


def test_trace_context_and_event_records_equal(tmp_path, monkeypatch):
    # a minted trace id numbers from its package's process-global counter,
    # which earlier tests in the same worker advance: start both afresh
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(
            f"{pkg}.observability.trace"), "_counter", itertools.count(1))
    want = _event_lines(JO, tmp_path / "j.jsonl")
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(
            f"{pkg}.observability.trace"), "_counter", itertools.count(1))
    got = _event_lines(TO, tmp_path / "t.jsonl")
    assert got == want and len(got) == 3
    assert TO.new_trace_id("req").startswith("req-")


def _bundle(FL, REC, O, tmp_path):
    fr = FL.FlightRecorder()
    armed = FL.flight_armed[0]
    FL.flight_armed[0] = True
    try:
        for i in range(5):
            fr.note_event({"ts": 0.0, "kind": "tick", "i": i})
        span = REC.make_span("unit.phase", 1000, 2000, "UserDefined",
                             "req-1", args={"k": 1})
        fr.note_span(span)
        fr.note_metrics("unit", {"x": 1})
        path = fr.dump_debug_bundle(str(tmp_path / FL.__name__),
                                    reason="unit")
    finally:
        FL.flight_armed[0] = armed
    with tarfile.open(path) as tar:
        names = sorted(tar.getnames())
        keys = {}
        for n in names:
            if n.endswith(".json"):
                doc = json.load(tar.extractfile(n))
                keys[n] = sorted(doc) if isinstance(doc, dict) else "list"
        events = [json.loads(line) for line in
                  tar.extractfile("events.jsonl").read().splitlines()]
        trace = json.load(tar.extractfile("trace.json"))
    FL.validate_bundle(path)
    return names, keys, events, [e["name"] for e in trace["traceEvents"]
                                 if e.get("ph") == "X"]


def test_flight_bundle_members_and_keys_equal(tmp_path):
    jn, jk, je, js = _bundle(JFL, JREC, JO, tmp_path)
    tn, tk, te, ts = _bundle(TFL, TREC, TO, tmp_path)
    assert tn == jn and "manifest.json" in tn
    # metrics.json holds each package's process registry (different
    # families registered); every other member's keys agree
    jk.pop("metrics.json")
    tk.pop("metrics.json")
    assert tk == jk
    assert te == je and ts == js == ["unit.phase"]


@pytest.mark.parametrize("tokens", [[], [0], [1, 2, 3, 2 ** 31 - 1],
                                    list(range(500)), np.arange(9, 0, -1)],
                         ids=["empty", "zero", "big", "long", "ndarray"])
def test_token_checksum_equal(tokens):
    assert TJ.token_checksum(tokens) == JJ.token_checksum(tokens)
    assert TD.token_checksum is TJ.token_checksum


def _journal(J):
    rec = J.JournalRecorder()
    rec.record_head(model={"layers": 2}, seed=3)
    rec.note_step(1, 1000.5)
    rec.note_arrival(0, 1000.5, [1, 2, 3], J.token_checksum([1, 2, 3]),
                     priority=1, deadline_ms=None, budget=4)
    rec.note_admit(srid=0, engine_rid=0, ns="paddle_serving")
    rec.note_outcome(0, "done", "complete", replica=None, failovers=0,
                     tokens=[5, 6, 7, 8],
                     stream_crc=J.token_checksum([5, 6, 7, 8]),
                     engine_crc=J.token_checksum([5, 6, 7, 8]))
    return rec


def test_journal_frames_equal():
    rj, rt = _journal(JJ), _journal(TJ)
    assert rt.frames() == rj.frames()
    assert rt.encode() == rj.encode()
    dec = TJ.decode_journal(rj.encode())
    assert [f["t"] for f in dec.frames] == ["step", "arrival", "admit",
                                            "outcome"]
    assert TJ.first_divergence(rt.frames(), rj.frames()) is None


# ---------------------------------------------------------------------------
# timelines over a served storm, and the engine's spans
# ---------------------------------------------------------------------------

def _storm_timeline(SV, T, eng, params, spec=False):
    T.span_collector.clear()
    T.span_collector.arm()
    try:
        clock = FakeClock()
        sched = SV.ServingScheduler(eng, SV.SchedulerConfig(), clock=clock,
                                    sleep=clock.sleep)
        hs = [sched.submit(p, priority=i % 2)
              for i, p in enumerate(_prompts(6, seed=11))]
        sched.run(params, max_steps=300)
        trees = {}
        for h in hs:
            spans = T.span_collector.spans(h.trace_id)
            tree = T.span_collector.tree(h.trace_id)
            att = T.span_collector.attribute(h.trace_id)
            trees[h.rid] = (sorted(Multiset(s.name for s in spans).items()),
                            [r["name"] for r in tree],
                            sorted(att["segments"]), att["complete"])
        return trees, [h.stream.tokens for h in hs]
    finally:
        T.span_collector.disarm()
        T.span_collector.clear()


def test_attribution_rounded_segments_tile_the_envelope():
    """Three 140 ns segments of a 420 ns request: rounded to 1e-4 ms
    each, they would add up to 0.0003 ms against an envelope of 0.0004;
    the port rounds their running sum, so they tile it exactly, each
    within one 1e-4 ms tick of the reference's own rounding."""
    names = ("paddle_serving_r0.queue_wait", "engine.prefill",
             "engine.decode_chunk")
    got = {}
    for pkg, rec in (("port", TREC), ("ref", JREC)):
        spans = [rec.make_span("router.request", 0, 420, trace_id="t")]
        spans += [rec.make_span(n, 140 * i, 140 * (i + 1), trace_id="t")
                  for i, n in enumerate(names)]
        got[pkg] = (TT if pkg == "port" else JT).attribute_spans(spans, "t")
    tl = got["port"]
    assert tl["e2e_ms"] == got["ref"]["e2e_ms"] == 0.0004
    assert sum(tl["segments"].values()) == pytest.approx(tl["e2e_ms"],
                                                         rel=1e-9)
    assert tl["segments"].keys() == got["ref"]["segments"].keys()
    for k, v in tl["segments"].items():
        assert abs(v - got["ref"]["segments"][k]) <= 1e-4 + 1e-12, k


@pytest.mark.parametrize("spec", [False, True], ids=["unified", "spec"])
def test_timeline_span_trees_from_served_storm_equal(spec):
    kw = dict(speculative=True, spec_k=2, step_tokens=8) if spec else {}
    jeng, teng = _pair(max_new=6, **kw)
    want = _storm_timeline(JSV, JT, jeng, W[1])
    got = _storm_timeline(TSV, TT, teng, W[3])
    assert got == want
    names = {n for tree in got[0].values() for n, _ in tree[0]}
    assert {"paddle_serving.request", "paddle_serving.queue_wait",
            "engine.prefill"} <= names
    assert ("engine.spec_round" in names) == spec


def test_engine_spans_close_after_the_fence(monkeypatch):
    """Spans open before the program call and close after its one
    device->host copy (the fence)."""
    _, teng = _pair()
    order = []
    real_run = teng._run

    def run(name, prog):
        order.append(("dispatch", TREC.spans_armed()))
        return real_run(name, prog)

    def note(spans):
        order.extend(("span", s.name) for s in spans)

    monkeypatch.setattr(teng, "_run", run)
    monkeypatch.setattr(TD, "emit_spans", note)
    TREC.host_recorder.enabled = True
    try:
        teng.serve(W[3], _prompts(2, seed=1))
    finally:
        TREC.host_recorder.enabled = False
        TREC.host_recorder.clear()
    assert order[0] == ("dispatch", True)
    assert ("span", "engine.decode_chunk") in order
    first_span = next(i for i, o in enumerate(order) if o[0] == "span")
    assert order[first_span - 1][0] == "dispatch"


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------

@pytest.fixture
def armed_ledgers():
    for M in (JM, TM):
        M.memory_ledger.reset()
        M.memory_ledger.arm()
    yield
    for M in (JM, TM):
        M.memory_ledger.disarm()
        M.memory_ledger.reset()


def test_pytree_nbytes_equal_on_the_same_weights():
    np_weights = {k: np.asarray(v) for k, v in W[1].items()}
    tp = TL.params_from_numpy(np_weights, W[2], "cpu")
    assert TM.pytree_nbytes(tp) == JM.pytree_nbytes(W[1]) == \
        JM.pytree_nbytes(np_weights)


@pytest.mark.parametrize("geo", [(2, 9, 4, 2, 16), (32, 513, 16, 32, 128)],
                         ids=["tiny", "llama2_7b"])
def test_plan_capacity_and_manager_bytes_equal(geo):
    layers, pages, page, nkv, d = geo
    small = layers * pages * page * nkv * d < 1e7
    mgrs = (JMgr(*geo), TMgr(*geo, device="cpu")) if small else ()
    for m in mgrs:
        assert m.page_nbytes == TM.page_nbytes(layers, page, nkv, d, 2)
        assert m.mesh_chips == 1
    kw = dict(num_layers=layers, num_kv_heads=nkv, head_dim=d,
              page_size=page, dtype_bytes=2,
              hbm_bytes=2 * pages * TM.page_nbytes(layers, page, nkv, d, 2)
              // 2, weight_bytes=0, max_seq_len=1024)
    pj, pt = JM.plan_capacity(**kw), TM.plan_capacity(**kw)
    assert pt.as_dict() == pj.as_dict()
    assert pt.max_pages == pages - 1
    if mgrs:
        assert TM.plan_verdict(pt, mgrs[1]) == JM.plan_verdict(pj, mgrs[0])
        assert TM.plan_verdict(pt, mgrs[1])["exact"]


def _strip_labels(snap):
    for p in snap["pools"]:
        p.pop("label")
        for r in p["requests"].values():
            r.pop("trace_id")
    return snap


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(speculative=True, spec_k=2,
                                     step_tokens=8)],
                         ids=["cache", "spec"])
def test_memory_ledger_split_over_a_serve_equal(armed_ledgers, kw):
    jeng, teng = _pair(max_new=6, **kw)
    prompts = _prompts(5, seed=4)
    prompts.append(prompts[0].copy())          # a cache hit
    for eng, p in ((jeng, W[1]), (teng, W[3])):
        eng.submit(prompts[0])
        for _ in range(2):
            eng.step(p)
        for q in prompts[1:]:
            eng.submit(q)
    mid = []
    for eng, p, M in ((jeng, W[1], JM), (teng, W[3], TM)):
        eng.step(p)
        mid.append(_strip_labels(M.memory_ledger.snapshot()))
        while eng._live or eng._queue:
            eng.step(p)
    assert mid[1] == mid[0]
    snaps = [_strip_labels(M.memory_ledger.snapshot()) for M in (JM, TM)]
    assert snaps[1] == snaps[0]
    assert snaps[1]["classes"]["weights"] == TM.pytree_nbytes(W[3])
    assert snaps[1]["pools"][0]["pool_bytes"] == (
        teng.mgr.k_pages.nbytes + teng.mgr.v_pages.nbytes)
    assert snaps[1]["pools"][0]["planner"]["exact"]


def test_oom_hook_fires_before_memory_error(armed_ledgers):
    for M, mgr in ((JM, JMgr(2, 4, 4, 2, 16)),
                   (TM, TMgr(2, 4, 4, 2, 16, device="cpu"))):
        calls = []
        real = mgr._oom
        mgr._oom = lambda src, need, real=real: (calls.append((src, need)),
                                                 real(src, need))
        mgr.allocate("a", 8)
        with pytest.raises(MemoryError):
            mgr.allocate("b", 12)
        with pytest.raises(MemoryError):
            mgr.extend("a", 8)
        assert calls == [("allocate", 3), ("extend", 1)]
        assert M.memory_ledger.last_oom["source"] == "extend"
    from paddle_tpu_torch.kvcache import RefcountedKVCacheManager
    pool = RefcountedKVCacheManager(2, 4, 4, 2, 16, device="cpu")
    pool.allocate("a", 12)
    with pytest.raises(MemoryError):
        pool.allocate("b", 4)
    assert TM.memory_ledger.last_oom["source"] == "allocate"


# ---------------------------------------------------------------------------
# SLO monitor, recompile detection, registry families
# ---------------------------------------------------------------------------

def _slo_run(O):
    clk = FakeClock(0.0)
    bad, total = [0.0], [0.0]
    seen = []
    mon = O.SLOMonitor(
        [O.ratio_objective("err", lambda: bad[0], lambda: total[0],
                           target=0.99)],
        clock=clk, fast_window_s=10, slow_window_s=1000, burn_threshold=5,
        on_breach=lambda n, s: seen.append(("breach", n)),
        on_recover=lambda n, s: seen.append(("recover", n)))
    health = []
    for phase, n, dbad, dtot, dt in (("good", 200, 0, 1, 5),
                                     ("blip", 10, 1, 1, 1),
                                     ("burn", 400, 1, 1, 5),
                                     ("heal", 20, 0, 10, 5)):
        for _ in range(n):
            bad[0] += dbad
            total[0] += dtot
            mon.tick()
            clk.advance(dt)
        health.append((phase, mon.health(), mon.breached()))
    st = mon.states()
    return health, seen, st


def test_slo_burn_rate_breach_and_recover_equal():
    want, got = _slo_run(JO), _slo_run(TO)
    assert got == want
    assert [h for _, h, _ in got[0]] == ["ok", "degraded", "breached", "ok"]


def test_recompile_records_equal_jax_engine(monkeypatch):
    jeng, teng = _pair(max_new=4, prefix_cache=True)
    seen = {"jax": [], "torch": []}
    for name, O in (("jax", JO), ("torch", TO)):
        monkeypatch.setattr(O.recompiles, "record_miss",
                            lambda fn, key, s=seen[name]: s.append((fn,
                                                                    key)))
    prompts = _prompts(4, seed=2)
    assert teng.serve(W[3], prompts) == jeng.serve(W[1], prompts)
    assert [n for n, _ in seen["torch"]] == [n for n, _ in seen["jax"]]
    # the JAX key carries its program flags after the port's
    assert all(tuple(wk[:len(gk)]) == gk for (_, gk), (_, wk)
               in zip(seen["torch"], seen["jax"]))
    assert seen["torch"] == teng.compile_misses
    before = TO.recompiles.compile_seconds_total("cbe.unified_step")
    teng2 = _pair(max_new=4)[1]
    teng2.serve(W[3], prompts[:1])
    assert TO.recompiles.compile_seconds_total("cbe.unified_step") > before


def _family_values(O, families):
    reg = O.get_registry()
    out = {}
    for fam in families:
        m = reg.get(fam)
        if m is None:
            out[fam] = None
            continue
        out[fam] = dict(m.snapshot()) if isinstance(m.snapshot(), dict) \
            else m.snapshot()
    return out


FAMILIES = ("paddle_sampling_requests_total", "paddle_sampling_tokens_total",
            "paddle_sampling_violations_total",
            "paddle_spec_drafted_tokens_total",
            "paddle_spec_accepted_tokens_total",
            "paddle_spec_rejected_tokens_total",
            "paddle_kvcache_hits_total", "paddle_kvcache_misses_total",
            "paddle_kvcache_cached_tokens_total")


def _delta(before, after):
    out = {}
    for fam, a in after.items():
        b = before.get(fam)
        if isinstance(a, dict):
            b = b or {}
            out[fam] = {k: v - (b.get(k, 0) or 0) for k, v in a.items()
                        if v != (b.get(k, 0) or 0)}
        else:
            out[fam] = (a or 0) - (b or 0)
    return out


def test_sampling_spec_and_cache_families_after_mixed_serves_equal():
    vocab = ["<eos>"] + list("abcde") + [f"tok{i}" for i in range(6, 256)]
    grams = (JC.compile_regex("(ab|cd)*e", vocab, eos_token_id=0),
             TC.compile_regex("(ab|cd)*e", vocab, eos_token_id=0))
    prompts = _prompts(4, seed=6)
    deltas = []
    for i, (O, D, Sampler, p) in enumerate(((JO, JD, JSampler, W[1]),
                                            (TO, TD, TSampler, W[3]))):
        before = _family_values(O, FAMILIES)
        dev = {} if i == 0 else {"device": "cpu"}
        geo = dict(num_slots=2, page_size=4, max_seq_len=48, chunk=2, **dev)
        cfg = W[0] if i == 0 else W[2]
        eng = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=6),
            grammar_states=grams[i].n_states, prefix_cache=True, **geo)
        subs = [dict(), dict(sampler=Sampler(temperature=0.8, top_k=20,
                                             seed=5)),
                dict(grammar=grams[i]), dict(sampler=Sampler(
                    temperature=1.2, top_p=0.9, seed=9))]
        rids = [eng.submit(q, **s) for q, s in zip(prompts, subs)]
        rids.append(eng.submit(prompts[0]))
        out = {}
        while len(out) < len(rids):
            eng.step(p)
            out.update(eng.collect())
        spec = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=8), speculative=True,
            spec_k=2, step_tokens=8, **geo)
        spec.serve(p, [np.tile(q[:3], 4) for q in prompts])
        deltas.append((_delta(before, _family_values(O, FAMILIES)),
                       [out[r] for r in rids], spec.spec.snapshot()))
    assert deltas[1] == deltas[0]
    d = deltas[1][0]
    assert d["paddle_sampling_requests_total"] and \
        d["paddle_sampling_tokens_total"]
    assert d["paddle_spec_drafted_tokens_total"]


# ---------------------------------------------------------------------------
# the engine's serving hooks
# ---------------------------------------------------------------------------

def _hook_run(eng, params, prompts, cancel_at=None):
    log = []

    def on_token(rid, tok):
        log.append(("token", rid, tok))
        if cancel_at is not None and (rid, sum(
                1 for e in log if e[:2] == ("token", rid))) == cancel_at:
            log.append(("cancel", rid, eng.cancel(rid)))

    eng.token_callback = on_token
    eng.finish_callback = lambda rid, toks: log.append(("finish", rid,
                                                        list(toks)))
    books = []
    for q in prompts:
        eng.submit(q, trace_id=f"req-{len(books)}")
        books.append((eng.num_free_slots, eng.num_queued))
    while eng._live or eng._queue:
        eng.step(params)
        books.append((eng.num_free_slots, eng.num_queued))
    return log, books, eng.collect(), eng.mgr.num_free_pages


@pytest.mark.parametrize("cancel_at", [None, (0, 2), (1, 1)],
                         ids=["plain", "self_cancel_mid_chunk",
                              "self_cancel_first_token"])
def test_callbacks_and_slot_books_equal_jax(cancel_at):
    jeng, teng = _pair(max_new=5)
    prompts = _prompts(4, seed=8)
    want = _hook_run(jeng, W[1], prompts, cancel_at)
    got = _hook_run(teng, W[3], prompts, cancel_at)
    assert got == want
    log = got[0]
    finished = {e[1] for e in log if e[0] == "finish"}
    if cancel_at is not None:
        assert ("cancel", cancel_at[0], True) in log
        assert cancel_at[0] not in finished
        assert sum(1 for e in log if e[:2] == ("token", cancel_at[0])) \
            == cancel_at[1]
    assert got[3] == teng.mgr.usable_pages
    assert teng.num_chips == 1 and teng.mesh is None
    teng.mgr.check_conservation()


def test_reentrant_cancel_keeps_the_next_program_inputs_consistent():
    """A callback cancelling its own request mid-unpack frees the slot
    at once; the next request admitted into it must decode exactly as in
    a fresh engine (its sampler row and grammar state rewritten)."""
    _, teng = _pair(max_new=5, num_slots=1)
    a, b = _prompts(2, seed=12)
    teng.submit(a, sampler=TSampler(temperature=0.9, seed=3))
    teng.token_callback = lambda rid, tok: rid == 0 and teng.cancel(0)
    rb = teng.submit(b)
    out = {}
    while teng._live or teng._queue:
        teng.step(W[3])
        out.update(teng.collect())
    fresh = _pair(max_new=5, num_slots=1)[1]
    assert out[rb] == fresh.serve(W[3], [b])[0]
    assert teng.mgr.num_free_pages == teng.mgr.usable_pages
