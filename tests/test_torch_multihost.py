"""Multi-host serving: ``paddle_tpu_torch.serving.multihost`` against
``paddle_tpu.serving.multihost``.

Every scenario of the JAX package's ``tests/test_multihost.py`` runs
through both stacks. The LocalTransport scenarios run both engine
"processes" in-process (every frame still round-trips the wire encoder)
on one fake clock, at tiny widths (``llama_tiny``, 2 layers, fp32). The
JAX hosts come from the reference's own ``llama_tiny_host``; the port's
are built in-process with the same geometry over the same JAX-made
weights carried across through numpy. Each scenario asserts the
reference test's own checks, and both stacks must agree on tokens,
states, failovers, breaker snapshots, migration summaries, counters,
statusz shapes and the event log's records; one scenario also holds the
frames themselves byte-equal.

The two real-process tests spawn the port's own children
(``llama_tiny_host`` with ``device="cpu"``, the port's seeded weights)
and hold the port to its own fault-free run, as the reference's tests
do; each has a wall-clock budget of its own."""

import itertools
import json
import tarfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.observability as JO
import paddle_tpu.observability.events as JEV
import paddle_tpu.resilience as JRS
import paddle_tpu.serving as JSV
import paddle_tpu_torch.observability as TO
import paddle_tpu_torch.observability.events as TEV
import paddle_tpu_torch.resilience as TRS
import paddle_tpu_torch.serving as TSV
from paddle_tpu.inference import constrain as JC
from paddle_tpu.inference import decoding as JD
from paddle_tpu.inference import sampling as JS
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import multihost as JMH
from paddle_tpu_torch.inference import constrain as TC
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference import sampling as TS
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import multihost as TMH
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

STACKS = {
    "jax": SimpleNamespace(name="jax", SV=JSV, MH=JMH, EV=JEV, O=JO, RS=JRS,
                           C=JC, S=JS),
    "torch": SimpleNamespace(name="torch", SV=TSV, MH=TMH, EV=TEV, O=TO,
                             RS=TRS, C=TC, S=TS),
}
CFG = JL.llama_tiny(num_hidden_layers=2)
_WEIGHTS = {}

#: event fields both stacks must agree on (trace ids, wall seconds and
#: error reprs are stack-specific)
EVENT_KEYS = ("request_id", "replica", "host", "inflight", "process_dead",
              "migrations", "src", "dst", "pages", "bytes",
              "imported_pages", "skipped_pages", "outcome", "streamed",
              "from_replica", "to_replica")


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def advance(self, dt):
        self.t += dt


def _torch_weights(seed=3, dtype=torch.float32):
    key = (seed, dtype)
    if key not in _WEIGHTS:
        jp = JL.init_stacked_params(CFG, seed=seed)
        tcfg = TL.llama_tiny(num_hidden_layers=2, dtype=dtype)
        _WEIGHTS[key] = (tcfg, TL.params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}, tcfg, "cpu"))
    return _WEIGHTS[key]


def tiny_host(st, seed=3, max_new_tokens=8, num_slots=2, page_size=4,
              max_seq_len=48, chunk=2, eos_token_id=None, grammar_states=0,
              dtype=torch.float32):
    """The reference's ``llama_tiny_host`` on the JAX stack; on the port
    the same engine over the JAX-made weights."""
    if st.name == "jax":
        return JMH.llama_tiny_host(
            seed=seed, max_new_tokens=max_new_tokens, num_slots=num_slots,
            page_size=page_size, max_seq_len=max_seq_len, chunk=chunk,
            eos_token_id=eos_token_id, grammar_states=grammar_states)
    cfg, params = _torch_weights(seed, dtype)
    eng = TD.ContinuousBatchingEngine(
        cfg, TD.GenerationConfig(max_new_tokens=max_new_tokens, seed=seed,
                                 eos_token_id=eos_token_id),
        num_slots=num_slots, page_size=page_size, max_seq_len=max_seq_len,
        chunk=chunk, prefix_cache=True, grammar_states=grammar_states,
        device="cpu")
    return eng, params


def local_fleet(st, n=2, max_new=8, health_kw=None, router_kw=None,
                injector=None, **fkw):
    """The reference's ``_local_fleet``: N hosts over LocalTransport."""
    fkw.setdefault("max_new_tokens", max_new)
    fkw.setdefault("max_seq_len", 48)
    router_kw = dict(router_kw or {})
    router_kw.setdefault("failover_backoff_s", 0.0)
    clock = FakeClock()
    hosts, engines = [], []
    for i in range(n):
        eng, params = tiny_host(st, **fkw)
        engines.append(eng)
        server = st.SV.HostServer(eng, params, host_id=i,
                                  scheduler_config=st.SV.SchedulerConfig(
                                      max_step_retries=1,
                                      retry_backoff_s=0.01))
        ep = st.SV.HostEndpoint(st.SV.LocalTransport(server), clock=clock,
                                sleep=clock.sleep)
        hosts.append(st.SV.HostHandle(
            i, ep, health_config=st.SV.HealthConfig(**(health_kw or {})),
            clock=clock, sleep=clock.sleep))
    router = st.SV.HostFleetRouter(hosts,
                                   config=st.SV.RouterConfig(**router_kw),
                                   clock=clock, sleep=clock.sleep,
                                   fault_injector=injector)
    return router, clock, hosts, engines


def drive(router, clock, dt=0.05, max_steps=500):
    steps = 0
    while router.pending:
        router.step(None)
        clock.advance(dt)
        steps += 1
        assert steps < max_steps, router.statusz()
    return steps


def prompt(seed=0, n=9):
    rng = np.random.RandomState(seed)
    return rng.randint(1, CFG.vocab_size, (n,)).astype(np.int32)


def ref_tokens(st, p, max_new, **sub):
    """Fault-free single-host reference stream."""
    router, clock, _, _ = local_fleet(st, n=1, max_new=max_new)
    h = router.submit(p, max_new_tokens=max_new, **sub)
    drive(router, clock)
    return list(h.stream.tokens)


def counter_total(st, name):
    m = st.O.get_registry().get(name)
    return 0.0 if m is None else m.total


def shape(d):
    """A statusz document's key structure (values are stack-specific
    where they are byte counts or wall times)."""
    if isinstance(d, dict):
        return {k: shape(v) for k, v in sorted(d.items())}
    return type(d).__name__


def health(hosts):
    return [h.health.snapshot() for h in hosts]


# ---------------------------------------------------------------------------
# scenarios (the JAX package's tests/test_multihost.py)
# ---------------------------------------------------------------------------

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def hello_facade_mirrors_engine_geometry(st, tmp):
    router, clock, hosts, engines = local_fleet(st, n=1)
    f, e = hosts[0].engine, engines[0]
    assert f.page_size == e.page_size
    assert f.max_seq_len == e.max_seq_len
    assert f.mgr.usable_pages == e.mgr.usable_pages
    assert f.mgr.pages_for(13) == e.mgr.pages_for(13)
    assert f.config.max_new_tokens == e.config.max_new_tokens
    assert f.has_prefix_cache
    return {"geometry": (f.page_size, f.max_seq_len, f.mgr.usable_pages,
                         f.page_nbytes, f.kv_dtype, f.mgr.pages_for(13),
                         f.config.max_new_tokens, f.config.eos_token_id)}


@scenario
def submit_step_complete_over_the_wire(st, tmp):
    router, clock, hosts, _ = local_fleet(st, n=2, max_new=6)
    frames = []
    for h in hosts:
        tr = h.endpoint.transport
        send, recv = tr.send, tr.recv

        def rec_send(buf, send=send):
            frames.append(bytes(buf))
            send(buf)

        def rec_recv(t, recv=recv):
            buf = recv(t)
            frames.append(bytes(buf))
            return buf

        tr.send, tr.recv = rec_send, rec_recv
    h = router.submit(prompt(), max_new_tokens=6)
    steps = drive(router, clock)
    assert h.state == "done" and len(h.stream.tokens) == 6
    assert h.stream.tokens == ref_tokens(st, prompt(), 6)
    ep = hosts[h.replica_id].endpoint
    assert ep.calls >= steps
    assert ep.bytes_sent > 0 and ep.bytes_received > 0
    # every frame so far byte-equal across the stacks (the statusz reply
    # below carries wall-clock step timings)
    wire = list(frames), ep.stats()
    st_ = hosts[h.replica_id].statusz()
    assert st_["host"]["host_id"] == h.replica_id
    assert st_["transport"]["alive"]
    return {"tokens": list(h.stream.tokens), "steps": steps,
            "replica": h.replica_id, "wire": wire, "statusz": shape(st_)}


@scenario
def infeasible_request_is_a_caller_error(st, tmp):
    router, clock, hosts, _ = local_fleet(st, n=1)
    with pytest.raises(ValueError):
        router.submit(prompt(n=9), max_new_tokens=10_000)
    for h in hosts:
        assert h.health.state == st.SV.ReplicaState.HEALTHY
    return {"health": health(hosts)}


@scenario
def missed_heartbeats_suspect_then_ejected(st, tmp):
    router, clock, hosts, _ = local_fleet(
        st, n=2, max_new=8, health_kw={"probe_cooldown_s": 1e9})
    h = router.submit(prompt(), max_new_tokens=8)
    for _ in range(2):
        router.step(None)
        clock.advance(0.05)
    victim = h.replica_id
    hosts[victim].kill()
    router.step(None)
    clock.advance(0.05)
    assert hosts[victim].health.state == st.SV.ReplicaState.SUSPECT
    drive(router, clock)
    assert hosts[victim].health.state == st.SV.ReplicaState.EJECTED
    assert h.state == "done" and h.failovers == 1
    g = st.O.get_registry().get("paddle_host_state")
    gauge = (g.value(host=str(victim)), g.value(host=str(1 - victim)))
    assert gauge == (2.0, 0.0)
    assert h.stream.tokens == ref_tokens(st, prompt(), 8)
    assert len(router._index[victim]) == 0
    return {"tokens": list(h.stream.tokens), "victim": victim,
            "gauge": gauge, "health": health(hosts)}


@scenario
def live_migration_byte_identical_with_prefill_skip(st, tmp):
    led = st.O.memory_ledger
    led.reset()
    led.arm()
    try:
        ref = ref_tokens(st, prompt(), 12)
        router, clock, hosts, engines = local_fleet(st, n=2, max_new=12)
        h = router.submit(prompt(), max_new_tokens=12)
        for _ in range(4):
            router.step(None)
            clock.advance(0.05)
        assert not h.done
        src = h.replica_id
        b0 = counter_total(st, "paddle_migration_bytes_total")
        p0 = counter_total(st, "paddle_migration_pages_total")
        c0 = counter_total(st, "paddle_kvcache_cached_tokens_total")
        summary = router.migrate_host(src)
        assert summary["dst"] != src and summary["requests"] == 1
        assert summary["pages"] >= 1 and summary["failed"] == 0
        assert h.replica_id == summary["dst"]
        drive(router, clock)
        assert list(h.stream.tokens) == ref
        served = counter_total(
            st, "paddle_kvcache_cached_tokens_total") - c0
        assert served >= summary["pages"] * engines[0].page_size
        assert counter_total(
            st, "paddle_migration_bytes_total") - b0 == summary["bytes"]
        assert counter_total(
            st, "paddle_migration_pages_total") - p0 == summary["pages"]
        mig = led.migration_snapshot()
        assert mig["totals"]["pages"] >= summary["pages"]
        assert mig["recent"][-1]["src_host"] == src
        assert mig["recent"][-1]["outcome"] == "ok"
        snap = router.multihost_snapshot()
        assert snap["migrations"][-1]["pages"] == summary["pages"]
        mh = router.statusz()["multihost"]
        assert mh["migrated_pages"] == summary["pages"]
        for e in engines:
            e.mgr.check_conservation()
        assert engines[src].mgr.num_live_pages == 0
    finally:
        led.disarm()
        led.reset()
    summary = dict(summary, seconds=None)
    entry = dict(snap["migrations"][-1], seconds=None)
    return {"tokens": list(h.stream.tokens), "summary": summary,
            "served": served, "log": entry, "multihost": mh,
            "hosts": {k: dict(v, transport=None)
                      for k, v in snap["hosts"].items()}}


@scenario
def migration_affinity_routes_same_prefix_to_dst(st, tmp):
    router, clock, hosts, _ = local_fleet(
        st, n=2, max_new=8, router_kw={"load_band": 8})
    h = router.submit(prompt(), max_new_tokens=8)
    for _ in range(3):
        router.step(None)
        clock.advance(0.05)
    src = h.replica_id
    dst = router.migrate_host(src)["dst"]
    router.undrain(src)
    aff0 = counter_total(st, "paddle_router_prefix_affinity_hits_total")
    h2 = router.submit(np.concatenate([prompt(), [3, 4]]).astype(np.int32),
                       max_new_tokens=8)
    assert h2.replica_id == dst
    aff = counter_total(st, "paddle_router_prefix_affinity_hits_total")
    assert aff - aff0 >= 1
    drive(router, clock)
    return {"tokens": [list(h.stream.tokens), list(h2.stream.tokens)],
            "dst": dst, "affinity": aff - aff0}


@scenario
def migration_failure_falls_back_to_recompute(st, tmp):
    ref = ref_tokens(st, prompt(), 10)
    router, clock, hosts, engines = local_fleet(st, n=2, max_new=10)
    h = router.submit(prompt(), max_new_tokens=10)
    for _ in range(3):
        router.step(None)
        clock.advance(0.05)
    src = h.replica_id
    dst = 1 - src

    def dying_import(tokens, ks, vs):
        raise st.SV.HostFault("DCN link dropped mid-transfer")

    hosts[dst].import_prefix = dying_import
    f0 = counter_total(st, "paddle_migration_requests_total")
    summary = router.migrate_host(src, dst)
    assert summary["failed"] == 1 and summary["requests"] == 0
    assert counter_total(st, "paddle_migration_requests_total") - f0 == 1
    drive(router, clock)
    assert h.state == "done" and list(h.stream.tokens) == ref
    for e in engines:
        e.mgr.check_conservation()
    return {"tokens": list(h.stream.tokens),
            "summary": dict(summary, seconds=None)}


def _abc_grammar(st):
    vocab = ["<eos>"] + list("abcde") + [
        f"tok{i}" for i in range(6, CFG.vocab_size)]
    return st.C.compile_regex("(ab|cd)(ab|cd)(ab|cd)e", vocab,
                              eos_token_id=0)


@scenario
def sampled_grammar_request_survives_host_kill_byte_identical(st, tmp):
    g = _abc_grammar(st)

    def fleet():
        return local_fleet(st, n=2, max_new=8, eos_token_id=0,
                           grammar_states=g.n_states,
                           health_kw={"probe_cooldown_s": 1e9})

    router, clock, hosts, _ = fleet()
    r1 = router.submit(prompt(), max_new_tokens=8,
                       sampler=st.S.SamplerConfig(temperature=0.8),
                       grammar=g)
    assert r1.sampler.seed is not None
    steps = 0
    while not r1.done:
        router.step(None)
        clock.advance(0.05)
        if len(r1.stream.tokens) >= 2 and r1.failovers == 0 \
                and hosts[r1.replica_id].endpoint.alive():
            hosts[r1.replica_id].kill()
        steps += 1
        assert steps < 500
    assert r1.failovers >= 1
    router2, clock2, _, _ = fleet()
    r2 = router2.submit(prompt(), max_new_tokens=8, sampler=r1.sampler,
                        grammar=g)
    drive(router2, clock2)
    assert r1.stream.tokens == r2.stream.tokens
    s = g.start
    for tok in r1.stream.tokens:
        assert g.legal(s, tok)
        s = g.advance(s, tok)
    return {"tokens": list(r1.stream.tokens), "failovers": r1.failovers,
            "seed": r1.sampler.seed}


@scenario
def link_slow_injects_latency_then_recovers(st, tmp):
    inj = st.RS.FaultInjector(schedule=[
        st.RS.Fault("link_slow", 2, host=0, delay_s=0.2)])
    router, clock, hosts, _ = local_fleet(st, n=2, max_new=6, injector=inj)
    h = router.submit(prompt(), max_new_tokens=6)
    t0 = clock()
    drive(router, clock)
    assert h.state == "done"
    assert h.stream.tokens == ref_tokens(st, prompt(), 6)
    assert inj.fired == [("link_slow", 2, 0)]
    assert clock() - t0 > 0.2
    assert hosts[0].health.state == st.SV.ReplicaState.HEALTHY
    return {"tokens": list(h.stream.tokens), "elapsed": clock() - t0,
            "fired": inj.fired, "health": health(hosts)}


@scenario
def host_stall_trips_breaker_then_heals(st, tmp):
    inj = st.RS.FaultInjector(schedule=[st.RS.Fault("host_stall", 2,
                                                    host=0)])
    router, clock, hosts, _ = local_fleet(
        st, n=2, max_new=6, injector=inj, health_kw={"eject_after": 99},
        router_kw={"stall_s": 0.2})
    h = router.submit(prompt(0), max_new_tokens=6)
    h2 = router.submit(prompt(5), max_new_tokens=6)
    drive(router, clock)
    assert h.state == "done" and h2.state == "done"
    assert ("host_stall", 2, 0) in inj.fired
    assert hosts[0].health.state == st.SV.ReplicaState.HEALTHY
    return {"tokens": [list(h.stream.tokens), list(h2.stream.tokens)],
            "fired": inj.fired, "health": health(hosts)}


@scenario
def seeded_hosts_schedule_is_deterministic_and_host_unique(st, tmp):
    a = st.RS.FaultInjector.seeded_hosts(7, num_steps=20, num_hosts=4,
                                         n_faults=3)
    b = st.RS.FaultInjector.seeded_hosts(7, num_steps=20, num_hosts=4,
                                         n_faults=3)
    sa = [(f.event, f.step, f.host, f.delay_s) for f in a.schedule]
    assert sa == [(f.event, f.step, f.host, f.delay_s) for f in b.schedule]
    hosts_hit = [f.host for f in a.schedule]
    assert len(set(hosts_hit)) == len(hosts_hit)
    for f in a.schedule:
        assert f.event in ("host_die", "host_stall", "link_slow")
        assert (f.delay_s is not None) == (f.event == "link_slow")
        assert 1 <= f.step <= 20
    return {"schedule": sa}


@scenario
def host_die_storm_byte_identical_no_leaks_no_slo_breach(st, tmp):
    prompts = [prompt(s, n=7 + s % 3) for s in range(3)]
    refs = [ref_tokens(st, p, 8) for p in prompts]
    inj = st.RS.FaultInjector(schedule=[st.RS.Fault("host_die", 3,
                                                    host=0)])
    fr = st.O.flight_recorder
    dump_dir = tmp / st.name
    dump_dir.mkdir()
    fr.clear()
    fr.arm(dump_dir=str(dump_dir))
    br0 = counter_total(st, "paddle_slo_breaches_total")
    try:
        router, clock, hosts, engines = local_fleet(
            st, n=2, max_new=8, injector=inj,
            health_kw={"probe_cooldown_s": 1e9})
        monitor = router.make_slo_monitor(completion_target=0.99)
        handles = [router.submit(p, max_new_tokens=8) for p in prompts]
        drive(router, clock)
        assert inj.fired == [("host_die", 3, 0)]
        for h, ref in zip(handles, refs):
            assert h.state == "done", h
            assert list(h.stream.tokens) == ref
        assert router.failed_total == 0 and router.shed_total == 0
        assert counter_total(st, "paddle_slo_breaches_total") == br0
        assert monitor.health() == "ok"
        assert router.pending == 0 and router.parked == 0
        survivor = engines[1]
        survivor.mgr.check_conservation()
        assert survivor.mgr.num_live_pages == 0
        assert survivor.mgr._tables == {}
        bundles = list(dump_dir.glob("paddle_debug_replica_ejected_0*"))
        assert bundles, list(dump_dir.iterdir())
        with tarfile.open(bundles[0]) as tf:
            mh = json.loads(tf.extractfile("multihost.json").read())
        assert "0" in mh["hosts"] and "migrations" in mh
        assert mh["hosts"]["0"]["health"]["state"] == "ejected"
    finally:
        fr.disarm()
        fr.clear()
    return {"tokens": [list(h.stream.tokens) for h in handles],
            "failovers": [h.failovers for h in handles],
            "replicas": [h.replica_id for h in handles],
            "bundle_hosts": {k: v["health"] for k, v in mh["hosts"].items()},
            "health": health(hosts)}


@scenario
def mirror_stream_closes_producer_dead_without_router(st, tmp):
    eng, params = tiny_host(st, max_new_tokens=6)
    server = st.SV.HostServer(eng, params, host_id=0)
    ep = st.SV.HostEndpoint(st.SV.LocalTransport(server))
    h = st.SV.HostHandle(0, ep)
    mirror = h.submit(prompt(), max_new_tokens=6)
    h.step(None)
    h.kill()
    mirror.stream._poll_s = 0.01
    toks = []
    while True:
        tok = mirror.stream.get(timeout=2.0)
        if tok is None:
            break
        toks.append(tok)
    assert mirror.stream.finished
    assert mirror.stream.error is not None
    assert mirror.stream.error.code == "producer_dead"
    return {"tokens": toks, "code": mirror.stream.error.code}


def _quiet(st):
    """Every tap of the stack disarmed (an earlier test in the worker may
    have left one armed: an armed flight recorder dumps on ejection)."""
    for tap in (st.O.flight_recorder, st.O.span_collector, st.O.journal,
                st.O.memory_ledger):
        tap.disarm()
    st.O.flight_recorder.clear()
    st.O.federation_armed[0] = False


def _traced(st, fn, monkeypatch, tmp):
    _quiet(st)
    events = []

    def emit(kind, **fields):
        if kind != "recompile":
            events.append((kind,) + tuple(
                (k, fields[k]) for k in EVENT_KEYS if k in fields))

    monkeypatch.setattr(st.EV.event_log, "emit", emit)
    monkeypatch.setattr(st.O.trace, "_counter", itertools.count(1))
    out = fn(st, tmp)
    out["events"] = events
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_stack(name, monkeypatch, tmp_path):
    want = _traced(STACKS["jax"], SCENARIOS[name], monkeypatch, tmp_path)
    got = _traced(STACKS["torch"], SCENARIOS[name], monkeypatch, tmp_path)
    assert got == want


# ---------------------------------------------------------------------------
# the port's extras: decoded= over the wire, the default factory
# ---------------------------------------------------------------------------

def test_fresh_submit_frame_is_the_reference_frame_and_decoded_rides_along():
    """A fresh submit's frame is byte-equal to the reference's; a
    continuation's ``decoded`` count is added to its meta (only when
    nonzero) and reaches the host's scheduler."""
    frames = {}
    for st in STACKS.values():
        eng, params = tiny_host(st)
        server = st.SV.HostServer(eng, params, host_id=0)
        tr = st.SV.LocalTransport(server)
        sent = []
        send = tr.send
        tr.send = lambda buf, send=send: (sent.append(bytes(buf)),
                                          send(buf))[1]
        h = st.SV.HostHandle(0, st.SV.HostEndpoint(tr))
        h.submit(prompt(), max_new_tokens=4, trace_id="t0")
        frames[st.name] = list(sent)
        if st.name == "torch":
            h.submit(prompt(1), max_new_tokens=4, trace_id="t1", decoded=3)
            _kind, meta, _ = TSV.decode_message(sent[-1])
            assert meta["decoded"] == 3
            assert server._reqs[1].decoded == 3
            assert server._reqs[0].decoded == 0
    assert frames["torch"] == frames["jax"]


def test_bf16_migrated_continuation_equals_the_uninterrupted_stream():
    """bf16 weights and pool on the CPU: a stream migrated mid-decode
    (``decoded`` > 0 on the continuation) equals the uninterrupted one,
    and the pages cross as ``bfloat16``."""
    st = STACKS["torch"]

    def fleet():
        return local_fleet(st, n=2, max_new=12, dtype=torch.bfloat16)

    router, clock, hosts, engines = fleet()
    assert hosts[0].engine.kv_dtype == "bfloat16"
    h = router.submit(prompt(), max_new_tokens=12)
    drive(router, clock)
    ref = list(h.stream.tokens)
    assert len(ref) == 12

    router, clock, hosts, engines = fleet()
    h = router.submit(prompt(), max_new_tokens=12)
    for _ in range(4):
        router.step(None)
        clock.advance(0.05)
    streamed = len(h.stream.tokens)
    assert 0 < streamed < 12
    src = h.replica_id
    summary = router.migrate_host(src)
    assert summary["requests"] == 1 and summary["pages"] >= 1
    dst_server = hosts[summary["dst"]].endpoint.transport.server
    cont = dst_server._reqs[h.handle.rid]
    assert cont.decoded == len(h.stream.tokens) >= streamed
    drive(router, clock)
    assert list(h.stream.tokens) == ref
    for e in engines:
        e.mgr.check_conservation()
    assert engines[src].mgr.num_live_pages == 0


def test_default_factory_builds_a_cpu_host_and_needs_a_device():
    eng, params = TMH.llama_tiny_host(max_new_tokens=4, device="cpu")
    assert eng.cache is not None and eng.device.type == "cpu"
    assert params["embed"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TMH.llama_tiny_host()


# ---------------------------------------------------------------------------
# real processes (the port's own children, on the CPU)
# ---------------------------------------------------------------------------

#: wall-clock budget of each spawned test (child start included)
SPAWN_BUDGET_S = 120.0


def _spawn_host(i, max_new=10):
    tr = TSV.PipeTransport(factory_kwargs={"max_new_tokens": max_new,
                                           "max_seq_len": 48,
                                           "device": "cpu"}, host_id=i)
    ep = TSV.HostEndpoint(tr, timeout_s=60.0)
    return TSV.HostHandle(i, ep, health_config=TSV.HealthConfig(
        probe_cooldown_s=1e9))


def test_two_processes_kill_one_mid_decode_byte_identical():
    deadline = time.monotonic() + SPAWN_BUDGET_S
    hosts = [_spawn_host(i) for i in range(2)]
    router = TSV.HostFleetRouter(hosts, config=TSV.RouterConfig())
    try:
        p = prompt()
        ref = router.submit(p, max_new_tokens=10)
        while router.pending:
            router.step(None)
            assert time.monotonic() < deadline
        ref_toks = list(ref.stream.tokens)
        assert len(ref_toks) == 10

        h = router.submit(p, max_new_tokens=10)
        steps = 0
        while not h.done:
            router.step(None)
            if len(h.stream.tokens) >= 3 and h.failovers == 0 and \
                    hosts[h.replica_id].endpoint.alive():
                hosts[h.replica_id].kill()    # real SIGKILL
            steps += 1
            assert steps < 1000 and time.monotonic() < deadline
        assert h.failovers == 1 and h.state == "done"
        assert list(h.stream.tokens) == ref_toks
        dead = [i for i in range(2) if not hosts[i].endpoint.alive()]
        assert len(dead) == 1
    finally:
        router.close()
    assert not any(h.endpoint.transport.alive() for h in hosts)


def test_real_process_death_closes_blocked_consumer():
    deadline = time.monotonic() + SPAWN_BUDGET_S
    h = _spawn_host(0, max_new=8)
    try:
        mirror = h.submit(prompt(), max_new_tokens=8)
        h.step(None)
        h.kill()
        mirror.stream._poll_s = 0.01
        while True:
            tok = mirror.stream.get(timeout=5.0)
            if tok is None:
                break
            assert time.monotonic() < deadline
        assert mirror.stream.finished
        assert mirror.stream.error is not None
        assert mirror.stream.error.code == "producer_dead"
    finally:
        h.close()
