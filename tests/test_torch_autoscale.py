"""Disaggregated prefill/decode serving and the autoscaler:
``paddle_tpu_torch.serving`` ``DisaggRouter``, ``ReplicaRole``, the
wire-framed KV page handoff, ``AutoscalePolicy`` and
``AutoscaleController`` over the port's CPU engines, against the JAX
package's over its engines.

Every scenario of the JAX package's ``tests/test_autoscale.py`` runs
through both stacks on the same ``llama_tiny`` (2 layers) weights, fp32,
with prefix-cache engines on one fake clock per fleet. Both runs assert
the reference test's own checks and must agree on: tokens and states per
request, where each request finished, handoff counts, pages and bytes,
every pool's books, the controller's decision records (actions, states,
phases, the signal snapshot each decided on) and the event log's records.
"""

import itertools
import json
import tarfile
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.observability as JO
import paddle_tpu.observability.events as JEV
import paddle_tpu.resilience as JRS
import paddle_tpu.serving as JSV
import paddle_tpu.serving.autoscale as JAS
import paddle_tpu_torch.observability as TO
import paddle_tpu_torch.observability.events as TEV
import paddle_tpu_torch.resilience as TRS
import paddle_tpu_torch.serving as TSV
import paddle_tpu_torch.serving.autoscale as TAS
from paddle_tpu.inference import constrain as JC
from paddle_tpu.inference import decoding as JD
from paddle_tpu.inference.sampling import SamplerConfig as JSampler
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import constrain as TC
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference.sampling import SamplerConfig as TSampler
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import one_cpu_thread
from test_torch_router import (EVENT_KEYS, FakeClock, _weights,
                               counter_total, greedy_ref, quiet)

one_cpu_thread()

STACKS = {
    "jax": SimpleNamespace(name="jax", D=JD, SV=JSV, EV=JEV, O=JO, RS=JRS,
                           AS=JAS, C=JC, Sampler=JSampler, dev={}),
    "torch": SimpleNamespace(name="torch", D=TD, SV=TSV, EV=TEV, O=TO,
                             RS=TRS, AS=TAS, C=TC, Sampler=TSampler,
                             dev={"device": "cpu"}),
}


def disagg_fleet(st, n=2, roles=None, max_new=4, num_slots=2, chunk=2,
                 seed=3, page_size=4, eos=None, health_kw=None,
                 router_kw=None, sched_kw=None, injector=None,
                 grammar_states=0, handoff_min_streamed=1):
    """The reference's ``_disagg_fleet``: role-tagged prefix-cache
    engines plus the factory pair the controller scales up from."""
    cfg, params = _weights(st, seed)
    clock = FakeClock()
    sched_kw = dict(sched_kw or {})
    sched_kw.setdefault("max_step_retries", 1)
    sched_kw.setdefault("retry_backoff_s", 0.01)
    engines = []

    def make_engine():
        eng = st.D.ContinuousBatchingEngine(
            cfg, st.D.GenerationConfig(max_new_tokens=max_new, seed=seed,
                                       eos_token_id=eos),
            num_slots=num_slots, page_size=page_size, max_seq_len=32,
            chunk=chunk, prefix_cache=True, grammar_states=grammar_states,
            **st.dev)
        engines.append(eng)
        return eng

    def make_handle(rid, eng):
        return st.SV.ReplicaHandle(
            rid, eng, config=st.SV.SchedulerConfig(**sched_kw),
            health_config=st.SV.HealthConfig(**(health_kw or {})),
            clock=clock, sleep=clock.sleep)

    replicas = [make_handle(i, make_engine()) for i in range(n)]
    router = st.SV.DisaggRouter(
        replicas, roles=roles, handoff_min_streamed=handoff_min_streamed,
        config=st.SV.RouterConfig(**(router_kw or {})), clock=clock,
        sleep=clock.sleep, fault_injector=injector)
    return SimpleNamespace(st=st, cfg=cfg, params=params, router=router,
                           replicas=replicas, clock=clock, engines=engines,
                           make_engine=make_engine, make_handle=make_handle)


def drive(env, dt=0.05, max_steps=400):
    steps = 0
    while env.router.pending:
        env.router.step(env.params)
        env.clock.advance(dt)
        steps += 1
        assert steps < max_steps, env.router.statusz()
    return steps


def pools(env):
    out = []
    for eng in env.engines:
        eng.mgr.check_conservation()
        out.append((eng.mgr.num_free_pages, eng.mgr.num_live_pages,
                    eng.mgr.num_cached_pages))
    return out


def summary(env, handles, **extra):
    r = env.router
    return dict(
        tokens=[list(h.stream.tokens) for h in handles],
        states=[h.state for h in handles],
        replica_ids=[h.replica_id for h in handles],
        failovers=[h.failovers for h in handles],
        handoffs=(r.handoffs_ok, r.handoffs_failed, r.handoff_pages_total),
        roles=dict(r.roles), pools=pools(env), **extra)


def abc_grammar(st, vocab_size):
    vocab = ["<eos>"] + list("abcde") + [
        f"tok{i}" for i in range(6, vocab_size)]
    return st.C.compile_regex("(ab|cd)(ab|cd)(ab|cd)e", vocab,
                              eos_token_id=0)


def ids(n0, n1):
    return np.arange(n0, n1, dtype=np.int32)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# the SignalSnapshot contract, roles and the KV page handoff
# ---------------------------------------------------------------------------

@scenario
def signal_snapshot_round_trips_and_versions(st):
    R = st.SV.ReplicaRole
    from importlib import import_module
    sig = import_module(st.O.__name__ + ".signals")
    env = disagg_fleet(st, n=2, roles={0: R.PREFILL, 1: R.DECODE})
    bus = env.router.attach_signal_bus(interval_s=0.1)
    env.router.submit(ids(3, 9))
    for _ in range(3):
        env.router.step(env.params)
        env.clock.advance(0.2)
        bus.tick()
    snap = bus.snapshot_contract()
    assert snap.schema_version == sig.SIGNAL_SNAPSHOT_VERSION
    assert "r0" in snap.per_replica and "r1" in snap.per_replica
    wire = json.loads(json.dumps(snap.as_dict()))
    assert sig.SignalSnapshot.from_dict(wire) == snap
    bad = dict(wire, schema_version=sig.SIGNAL_SNAPSHOT_VERSION + 1)
    with pytest.raises(ValueError, match="schema_version"):
        sig.SignalSnapshot.from_dict(bad)
    doc = bus.history_snapshot()
    assert doc["contract"]["schema_version"] == sig.SIGNAL_SNAPSHOT_VERSION
    assert doc["contract"]["queue_depth"] == snap.queue_depth
    drive(env)
    return dict(snap=wire, contract=doc["contract"], values=bus.values())


@scenario
def prefill_decode_handoff_greedy_byte_identical(st):
    R = st.SV.ReplicaRole
    env = disagg_fleet(st, n=2, roles={0: R.PREFILL, 1: R.DECODE},
                       max_new=6)
    p = ids(3, 13)
    pages0 = counter_total(st, "paddle_handoff_pages_total")
    bytes0 = counter_total(st, "paddle_handoff_bytes_total")
    h = env.router.submit(p)
    assert h.replica_id == 0
    drive(env)
    assert h.state == st.SV.RequestState.DONE and h.replica_id == 1
    assert env.router.handoffs_ok == 1 and env.router.handoffs_failed == 0
    assert env.router.handoff_pages_total >= 2
    assert counter_total(st, "paddle_handoff_pages_total") - pages0 \
        == env.router.handoff_pages_total
    assert h.stream.result() == greedy_ref(p, 6)
    out = summary(env, [h], bytes=counter_total(
        st, "paddle_handoff_bytes_total") - bytes0)
    assert all(live == 0 for _, live, _ in out["pools"])
    return out


@scenario
def handoff_sampled_and_grammar_byte_identical(st):
    R = st.SV.ReplicaRole
    g = abc_grammar(st, _weights(st)[0].vocab_size)

    def run(roles):
        env = disagg_fleet(st, n=2, roles=roles, max_new=8, eos=0,
                           grammar_states=g.n_states)
        p = ids(3, 13)
        hs = [env.router.submit(p, sampler=st.Sampler(temperature=0.8)),
              env.router.submit(p + 1, grammar=g)]
        drive(env)
        assert all(h.state == st.SV.RequestState.DONE for h in hs)
        return env, hs

    disagg, hs = run({0: R.PREFILL, 1: R.DECODE})
    assert disagg.router.handoffs_ok >= 2
    assert all(h.replica_id == 1 for h in hs)
    hybrid, hs2 = run(None)
    assert hybrid.router.handoffs_ok == 0
    moved = [list(h.stream.tokens) for h in hs]
    assert moved == [list(h.stream.tokens) for h in hs2]
    state = g.start
    for tok in moved[1]:
        assert g.legal(state, tok)
        state = g.advance(state, tok)
    return dict(disagg=summary(disagg, hs), hybrid=summary(hybrid, hs2))


@scenario
def decode_replica_is_last_resort_for_fresh_admissions(st):
    R = st.SV.ReplicaRole
    env = disagg_fleet(st, n=2, roles={0: R.PREFILL, 1: R.DECODE},
                       health_kw={"eject_after": 1,
                                  "probe_cooldown_s": 1e9})
    hs = [env.router.submit(ids(i, i + 6)) for i in range(1, 4)]
    assert all(h.replica_id == 0 for h in hs)
    drive(env)
    env.replicas[0].kill()
    h = env.router.submit(ids(11, 17))
    drive(env)
    assert h.state == st.SV.RequestState.DONE and h.replica_id == 1
    return summary(env, hs + [h])


@scenario
def handoff_failure_leaves_request_completing(st):
    R = st.SV.ReplicaRole
    env = disagg_fleet(st, n=2, roles={0: R.PREFILL, 1: R.DECODE},
                       max_new=6)

    def dying_import(tokens, ks, vs):
        raise RuntimeError("import torn mid-transfer")

    env.engines[1].cache.import_prefix = dying_import
    f0 = counter_total(st, "paddle_handoff_requests_total")
    p = ids(3, 13)
    h = env.router.submit(p)
    drive(env)
    assert h.state == st.SV.RequestState.DONE
    assert env.router.handoffs_failed == 1
    assert counter_total(st, "paddle_handoff_requests_total") - f0 >= 1
    assert h.stream.result() == greedy_ref(p, 6)
    out = summary(env, [h])
    assert all(live == 0 for _, live, _ in out["pools"])
    return out


@scenario
def role_flip_emits_event_and_gauge(st):
    R = st.SV.ReplicaRole
    env = disagg_fleet(st, n=2)
    assert env.router.role(0) == R.HYBRID
    env.router.set_role(0, R.PREFILL, reason="operator")
    env.router.set_role(0, R.PREFILL)
    assert env.router.statusz()["roles"]["0"] == "prefill"
    with pytest.raises(ValueError):
        env.router.set_role(1, "turbo")
    gauge = st.O.get_registry().get("paddle_router_replica_role")
    return dict(roles=env.router.statusz()["roles"],
                gauge=gauge.value(replica="0"))


@scenario
def parked_deadline_shed_observes_age_and_event(st):
    env = disagg_fleet(st, n=1, health_kw={"eject_after": 1,
                                           "probe_cooldown_s": 1e9})
    env.replicas[0].kill()
    h = env.router.submit(ids(3, 9), deadline_ms=500)
    env.router.step(env.params)
    env.clock.advance(0.05)
    env.router.step(env.params)
    assert env.router.parked == 1
    reg = st.O.get_registry()
    c0 = reg.get("paddle_router_parked_age_seconds").hist().count
    env.clock.advance(1.0)
    env.router.step(env.params)
    assert h.state == st.SV.RequestState.SHED
    hist = reg.get("paddle_router_parked_age_seconds").hist()
    assert hist.count == c0 + 1 and hist.max >= 0.9
    return summary(env, [h], age_max=hist.max)


# ---------------------------------------------------------------------------
# the policy over synthetic snapshots
# ---------------------------------------------------------------------------

def snap(st, queue_depth=0.0, trend=0.0, wait_share=0.0, pressure=0.0,
         burn=0.0, acceptance=1.0, pending=0.0, parked=0.0,
         per_replica=None):
    sig = st.AS
    return sig.SignalSnapshot(
        schema_version=1, t=0.0, queue_depth=queue_depth,
        queue_depth_trend=trend, queue_wait_share=wait_share,
        page_pressure=pressure, slo_fast_burn=burn,
        spec_acceptance=acceptance, pending=pending, parked=parked,
        per_replica=per_replica or {})


def _d(d):
    return None if d is None else (d.action, d.reason, d.replica_id, d.role)


@scenario
def policy_hysteresis_and_cooldown(st):
    R, A = st.SV.ReplicaRole, st.SV
    pol = A.AutoscalePolicy(A.AutoscaleConfig(evidence_rounds=2,
                                              cooldown_s=10.0,
                                              max_replicas=4))
    roles = {0: R.HYBRID, 1: R.HYBRID}
    hot = snap(st, parked=1.0)
    out = [_d(pol.decide(hot, roles, t=t)) for t in (0.0, 1.0, 2.0, 3.0,
                                                     12.0)]
    assert out[0] is None and out[1][0] == "scale_up"
    assert "parked" in out[1][1]
    assert out[2] is None and out[3] is None and out[4][0] == "scale_up"
    pol2 = A.AutoscalePolicy(A.AutoscaleConfig(evidence_rounds=2))
    out2 = [_d(pol2.decide(hot, roles, 0.0)),
            _d(pol2.decide(snap(st, queue_depth=1.0), roles, 1.0)),
            _d(pol2.decide(hot, roles, 2.0))]
    assert out2 == [None, None, None]
    return dict(out=out, out2=out2)


@scenario
def policy_overload_evidence_maps_the_contract(st):
    pol = st.SV.AutoscalePolicy(st.SV.AutoscaleConfig())
    n = 2
    assert pol.overload_evidence(snap(st), n) == []
    assert pol.overload_evidence(snap(st, queue_depth=20.0), n) == []
    out = [pol.overload_evidence(snap(st, queue_depth=20.0, trend=0.5), n)]
    assert any("queue_depth" in e for e in out[0])
    for kw, tag in ((dict(burn=2.0), "slo_fast_burn"),
                    (dict(wait_share=0.7), "queue_wait_share"),
                    (dict(pressure=0.9), "page_pressure"),
                    (dict(acceptance=0.5), "spec_acceptance"),
                    (dict(parked=2.0), "parked")):
        ev = pol.overload_evidence(snap(st, **kw), n)
        assert any(tag in e for e in ev), tag
        out.append(ev)
    return dict(out=out)


@scenario
def policy_scale_down_picks_idle_hybrid_first(st):
    R, A = st.SV.ReplicaRole, st.SV
    pol = A.AutoscalePolicy(A.AutoscaleConfig(evidence_rounds=2,
                                              min_replicas=1))
    roles = {0: R.PREFILL, 1: R.HYBRID, 2: R.DECODE}
    cold = snap(st, per_replica={f"r{i}": {"queue_depth": 0.0}
                                 for i in range(3)})
    assert pol.decide(cold, roles, 0.0) is None
    d = pol.decide(cold, roles, 1.0)
    assert d is not None and d.action == "scale_down" and d.replica_id == 1
    pol2 = A.AutoscalePolicy(A.AutoscaleConfig(evidence_rounds=1,
                                               min_replicas=1))
    assert pol2.decide(cold, {0: R.HYBRID}, 0.0) is None
    return dict(d=_d(d))


@scenario
def policy_rebalances_roles_at_max_replicas(st):
    R, A = st.SV.ReplicaRole, st.SV
    pol = A.AutoscalePolicy(A.AutoscaleConfig(evidence_rounds=1,
                                              max_replicas=3,
                                              rebalance_backlog=2.0))
    roles = {0: R.PREFILL, 1: R.PREFILL, 2: R.DECODE}
    hot = snap(st, parked=1.0, per_replica={"r0": {"queue_depth": 4.0},
                                            "r1": {"queue_depth": 4.0},
                                            "r2": {"queue_depth": 0.0}})
    d = pol.decide(hot, roles, 0.0)
    assert d is not None and d.action == "role_change"
    assert d.replica_id == 2 and d.role == R.PREFILL
    back = snap(st, per_replica={"r0": {"queue_depth": 0.0},
                                 "r1": {"queue_depth": 0.0},
                                 "r2": {"queue_depth": 5.0}})
    d2 = pol._rebalance(back, roles)
    assert d2 is not None and d2.role == R.DECODE and d2.replica_id == 0
    assert pol._rebalance(back, {0: R.PREFILL, 2: R.DECODE}) is None
    return dict(d=_d(d), d2=_d(d2))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class ScriptPolicy:
    """Canned decisions, in order; None once the script runs dry."""

    def __init__(self, st, decisions):
        self.config = st.SV.AutoscaleConfig()
        self._script = list(decisions)

    def decide(self, snap, roles, t):
        return self._script.pop(0) if self._script else None


@scenario
def controller_scale_up_role_change_scale_down(st):
    R, A = st.SV.ReplicaRole, st.SV
    env = disagg_fleet(st, n=1)
    script = ScriptPolicy(st, [
        A.Decision("scale_up", "test", role=R.PREFILL),
        A.Decision("role_change", "test", replica_id=1, role=R.DECODE),
        A.Decision("scale_down", "test", replica_id=1)])
    ctl = A.AutoscaleController(env.router, env.make_engine,
                                env.make_handle, policy=script,
                                interval_s=0.1)
    rec = ctl.evaluate()
    assert rec.action == "scale_up" and rec.state == "done"
    assert rec.replica_id == 1 and len(env.router.replicas) == 2
    assert env.router.role(1) == R.PREFILL and len(env.engines) == 2
    assert any(n.startswith("r1.") for n in ctl.bus.values())
    env.clock.advance(0.2)
    rec2 = ctl.evaluate()
    assert rec2.action == "role_change" and rec2.state == "applying"
    assert env.router.replicas[1].draining
    env.clock.advance(0.2)
    rec3 = ctl.evaluate()
    assert rec2.state == "done" and env.router.role(1) == R.DECODE
    assert [p["phase"] for p in rec2.phases] == ["drain", "retag",
                                                 "undrain"]
    assert rec3.action == "scale_down" and rec3.state == "applying"
    env.clock.advance(0.2)
    ctl.evaluate()
    assert rec3.state == "done"
    assert len(env.router.replicas) == 1 and 1 not in env.router.replicas
    doc = ctl.timeline_snapshot()
    assert doc["kind"] == "paddle_tpu.autoscale"
    assert doc["replicas"] == 1 and doc["pending_ops"] == []
    assert [r["action"] for r in doc["records"]] == [
        "scale_up", "role_change", "scale_down"]
    assert doc["records"][0]["snapshot"]["schema_version"] == 1
    return dict(doc=doc)


@scenario
def controller_drain_waits_for_live_requests(st):
    A = st.SV
    env = disagg_fleet(st, n=2, max_new=6)
    script = ScriptPolicy(st, [A.Decision("scale_down", "test",
                                          replica_id=0)])
    ctl = A.AutoscaleController(env.router, env.make_engine,
                                env.make_handle, policy=script,
                                interval_s=0.05)
    h = env.router.submit(ids(3, 9))
    assert h.replica_id == 0
    rec = ctl.evaluate()
    assert rec.state == "applying" and 0 in env.router.replicas
    steps = 0
    while h.state != A.RequestState.DONE or 0 in env.router.replicas:
        ctl.step(env.params)
        env.clock.advance(0.05)
        steps += 1
        assert steps < 200, ctl.timeline_snapshot()
    assert rec.state == "done" and len(env.router.replicas) == 1
    return summary(env, [h], steps=steps, doc=ctl.timeline_snapshot())


@scenario
def scalez_endpoint_and_flight_bundle(st):
    import tempfile
    R, A = st.SV.ReplicaRole, st.SV
    env = disagg_fleet(st, n=2, roles={0: R.PREFILL, 1: R.DECODE})
    ctl = A.AutoscaleController(env.router, env.make_engine,
                                env.make_handle, interval_s=0.1)
    srv = st.O.DiagServer(port=0)
    try:
        srv.attach_autoscale(ctl)
        port = srv.start()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/scalez",
                                    timeout=10) as resp:
            doc = json.loads(resp.read())
        assert doc["kind"] == "paddle_tpu.autoscale"
        assert doc["roles"] == {"0": "prefill", "1": "decode"}
        assert "autoscale" in srv.statusz()
    finally:
        srv.stop()
    bare = st.O.DiagServer(port=0)
    try:
        bare.start()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{bare.port}/scalez",
                                   timeout=10)
        assert ei.value.code == 404
    finally:
        bare.stop()
    fr = st.O.flight_recorder
    with tempfile.TemporaryDirectory() as tmp:
        try:
            fr.arm(capacity=64, dump_dir=tmp)
            path = fr.dump_debug_bundle(f"{tmp}/bundle.tar.gz",
                                        reason="test")
            with tarfile.open(path) as tar:
                assert "autoscale.json" in tar.getnames()
                bundled = json.loads(tar.extractfile(
                    "autoscale.json").read())
        finally:
            fr.disarm()
            fr.clear()
            fr._autoscale = None
            fr._dump_dir = None
    assert bundled["kind"] == "paddle_tpu.autoscale"
    assert bundled["config"]["max_replicas"] == ctl.config.max_replicas
    return dict(doc=doc, bundled=bundled)


# ---------------------------------------------------------------------------
# chaos acceptance: diurnal burst + mid-burst replica death
# ---------------------------------------------------------------------------

def diurnal_prompts(cfg, seed=31):
    rng = np.random.RandomState(seed)
    sched = {}
    for step in (0, 8):
        n = int(rng.randint(4, 7))
        sched[step] = [rng.randint(1, cfg.vocab_size, (n,))
                       .astype(np.int32)]
    for step, k in ((16, 6), (18, 6), (20, 4)):
        sched[step] = [rng.randint(1, cfg.vocab_size,
                                   (int(rng.randint(10, 13)),))
                       .astype(np.int32) for _ in range(k)]
    return sched


def run_schedule(driver_step, router, clock, sched, max_steps=600):
    handles, step = [], 0
    sched = dict(sched)
    while step < max_steps:
        for p in sched.pop(step, []):
            handles.append(router.submit(p, max_new_tokens=4))
        if not sched and not router.pending:
            break
        driver_step()
        clock.advance(0.05)
        step += 1
    assert step < max_steps, router.statusz()
    return handles


@scenario
def autoscaled_chaos_diurnal_byte_identical(st):
    R, A = st.SV.ReplicaRole, st.SV
    sched = diurnal_prompts(_weights(st)[0])
    ref = disagg_fleet(st, n=4, max_new=4)
    ref_handles = run_schedule(lambda: ref.router.step(ref.params),
                               ref.router, ref.clock, sched)
    assert all(h.state == A.RequestState.DONE for h in ref_handles)
    ref_out = [list(h.stream.tokens) for h in ref_handles]
    injector = st.RS.FaultInjector(schedule=[
        st.RS.Fault("replica_die", 20, replica=1)])
    env = disagg_fleet(st, n=3, roles={0: R.PREFILL, 1: R.PREFILL,
                                       2: R.DECODE},
                       max_new=4, injector=injector,
                       health_kw={"suspect_after": 1, "eject_after": 2,
                                  "probe_cooldown_s": 1e9},
                       router_kw={"failover_backoff_s": 0.05})
    monitor = env.router.make_slo_monitor(completion_target=0.95,
                                          min_events=1)
    ctl = A.AutoscaleController(
        env.router, env.make_engine, env.make_handle,
        config=A.AutoscaleConfig(min_replicas=3, max_replicas=4,
                                 up_queue_depth=1.0, up_trend=-1e9,
                                 evidence_rounds=2, cooldown_s=0.4,
                                 rebalance_backlog=0.5),
        interval_s=0.1)
    handles = run_schedule(lambda: ctl.step(env.params), env.router,
                           env.clock, sched)
    assert all(h.state == A.RequestState.DONE for h in handles)
    actions = [r.action for r in ctl.records if r.state == "done"]
    assert "scale_up" in actions and "role_change" in actions
    assert all(r.snapshot["schema_version"] == 1 for r in ctl.records)
    assert [list(h.stream.tokens) for h in handles] == ref_out
    assert not monitor.breached() and monitor.health() == "ok"
    out = summary(env, handles, records=[r.as_dict() for r in ctl.records],
                  ref_pools=pools(ref))
    assert all(live == 0 for _, live, _ in out["pools"] + out["ref_pools"])
    return out


# ---------------------------------------------------------------------------
# the parity test over every scenario
# ---------------------------------------------------------------------------

def _traced(st, fn, monkeypatch):
    quiet(st)
    events = []

    def emit(kind, **fields):
        if kind != "recompile":
            events.append((kind,) + tuple(
                (k, fields[k]) for k in EVENT_KEYS + ("replicas", "age_s")
                if k in fields))

    monkeypatch.setattr(st.EV.event_log, "emit", emit)
    monkeypatch.setattr(st.O.trace, "_counter", itertools.count(1))
    # scale-record sequence numbers are process-global per package
    monkeypatch.setattr(st.AS, "_REC_SEQ", itertools.count(1))
    out = fn(st)
    out["events"] = events
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_stack(name, monkeypatch):
    want = _traced(STACKS["jax"], SCENARIOS[name], monkeypatch)
    got = _traced(STACKS["torch"], SCENARIOS[name], monkeypatch)
    assert got == want


def test_handoff_records_its_phase_split():
    """The port's handoff keeps each transfer's wall seconds split into
    export, wire and import (what the card's smoke reports)."""
    st = STACKS["torch"]
    R = st.SV.ReplicaRole
    env = disagg_fleet(st, n=2, roles={0: R.PREFILL, 1: R.DECODE},
                       max_new=6)
    env.router.submit(ids(3, 13))
    drive(env)
    (ph,) = env.router.handoff_phases
    assert ph["pages"] == env.router.handoff_pages_total >= 2
    assert ph["bytes"] == ph["pages"] * env.engines[0].mgr.page_nbytes
    assert min(ph["export_s"], ph["wire_s"], ph["import_s"]) >= 0.0
