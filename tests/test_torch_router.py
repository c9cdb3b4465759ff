"""The fleet router: ``paddle_tpu_torch.serving.FleetRouter`` over the
port's replicas (CPU engines) against ``paddle_tpu.serving.FleetRouter``
over the JAX engines.

Every scenario of the JAX package's router tests (``tests/test_router.py``
l.101-790) runs through both stacks on the same ``llama_tiny`` (2 layers)
weights (JAX-made, carried across through numpy), fp32, on one shared
fake clock per fleet. Both runs assert the reference test's own checks
and must agree on: tokens, states, replica and failover counts per
request, every replica's breaker snapshot, the router's counters and
registry families, fired faults, and the event log's records (kind,
request, replicas, streamed counts). Greedy streams are also held to the
JAX full-reforward oracle."""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.observability as JO
import paddle_tpu.observability.events as JEV
import paddle_tpu.resilience as JRS
import paddle_tpu.serving as JSV
import paddle_tpu_torch.observability as TO
import paddle_tpu_torch.observability.events as TEV
import paddle_tpu_torch.resilience as TRS
import paddle_tpu_torch.serving as TSV
from paddle_tpu.inference import decoding as JD
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

STACKS = {
    "jax": SimpleNamespace(name="jax", L=JL, D=JD, SV=JSV, EV=JEV, O=JO,
                           RS=JRS, dev={}),
    "torch": SimpleNamespace(name="torch", L=TL, D=TD, SV=TSV, EV=TEV,
                             O=TO, RS=TRS, dev={"device": "cpu"}),
}
_WEIGHTS = {}
_ORACLE = {}

#: event fields both stacks must agree on (trace ids, wall seconds and
#: error reprs are stack-specific)
EVENT_KEYS = ("request_id", "replica", "from_replica", "to_replica",
              "streamed", "via", "exhausted", "reason", "src", "dst",
              "pages", "outcome", "role", "previous", "action")


class FakeClock:
    """Deterministic fleet clock; sleep() advances it."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def advance(self, dt):
        self.t += dt


def _weights(st, seed=3):
    if seed not in _WEIGHTS:
        cfg = JL.llama_tiny(num_hidden_layers=2)
        jp = JL.init_stacked_params(cfg, seed=seed)
        tcfg = TL.llama_tiny(num_hidden_layers=2)
        tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                  tcfg, "cpu")
        _WEIGHTS[seed] = {"jax": (cfg, jp), "torch": (tcfg, tp)}
    return _WEIGHTS[seed][st.name]


def greedy_ref(prompt, n_new, seed=3):
    """The JAX package's full-reforward greedy oracle (its
    ``tests/test_router.py::_greedy_ref``), shared by both stacks."""
    key = (tuple(int(t) for t in prompt), n_new, seed)
    if key not in _ORACLE:
        import jax.numpy as jnp
        cfg, params = _weights(STACKS["jax"], seed)
        seq = np.asarray(prompt, np.int32)[None, :]
        out = []
        for _ in range(n_new):
            logits = JL.forward_stacked(params, jnp.asarray(seq), cfg)
            nxt = int(np.asarray(jnp.argmax(
                logits[0, -1].astype(jnp.float32))))
            out.append(nxt)
            seq = np.concatenate([seq, [[nxt]]], axis=1).astype(np.int32)
        _ORACLE[key] = out
    return list(_ORACLE[key])


def _engine(st, max_new=4, num_slots=2, chunk=2, seed=3, page_size=4,
            eos=None, speculative=False):
    cfg, _ = _weights(st, seed)
    return st.D.ContinuousBatchingEngine(
        cfg, st.D.GenerationConfig(max_new_tokens=max_new, seed=seed,
                                   eos_token_id=eos),
        num_slots=num_slots, page_size=page_size, max_seq_len=32,
        chunk=chunk, speculative=speculative, **st.dev)


def _handle(st, rid, clock, sched_kw=None, health_kw=None, **eng_kw):
    sched_kw = dict(sched_kw or {})
    sched_kw.setdefault("max_step_retries", 1)
    sched_kw.setdefault("retry_backoff_s", 0.01)
    return st.SV.ReplicaHandle(
        rid, _engine(st, **eng_kw),
        config=st.SV.SchedulerConfig(**sched_kw),
        health_config=st.SV.HealthConfig(**(health_kw or {})),
        clock=clock, sleep=clock.sleep)


def fleet(st, n=2, health_kw=None, router_kw=None, sched_kw=None,
          injector=None, **eng_kw):
    """The reference's ``_fleet``: n replicas on one fake clock."""
    cfg, params = _weights(st, eng_kw.get("seed", 3))
    clock = FakeClock()
    replicas = [_handle(st, i, clock, sched_kw, health_kw, **eng_kw)
                for i in range(n)]
    router = st.SV.FleetRouter(
        replicas, config=st.SV.RouterConfig(**(router_kw or {})),
        clock=clock, sleep=clock.sleep, fault_injector=injector)
    return SimpleNamespace(st=st, cfg=cfg, params=params, router=router,
                           replicas=replicas, clock=clock)


def drive(env, dt=0.05, max_steps=400):
    steps = 0
    while env.router.pending:
        env.router.step(env.params)
        env.clock.advance(dt)
        steps += 1
        assert steps < max_steps, env.router.statusz()
    return steps


def counter_total(st, name):
    m = st.O.get_registry().get(name)
    return 0.0 if m is None else m.total


def summary(env, handles, **extra):
    """What both stacks must agree on after a scenario."""
    r = env.router
    return dict(
        tokens=[list(h.stream.tokens) for h in handles],
        states=[h.state for h in handles],
        reasons=[h.stream.finish_reason for h in handles],
        replica_ids=[h.replica_id for h in handles],
        failovers=[h.failovers for h in handles],
        health={rid: rep.health.snapshot()
                for rid, rep in sorted(r.replicas.items())},
        counters=(r.accepted_total, r.failed_total, r.shed_total),
        parked=r.statusz()["parked"], pending=r.pending, **extra)


def ids(n0, n1):
    return np.arange(n0, n1, dtype=np.int32)


# ---------------------------------------------------------------------------
# scenarios (the JAX package's tests/test_router.py, l.101-790)
# ---------------------------------------------------------------------------

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def prefix_affinity_beats_load_only_within_band(st):
    env = fleet(st, n=2, router_kw={"load_band": 1})
    rng = np.random.RandomState(21)
    base = rng.randint(1, env.cfg.vocab_size, (8,)).astype(np.int32)

    def prompt(i):
        return np.concatenate([base, [i + 1, i + 2]]).astype(np.int32)

    name = "paddle_router_prefix_affinity_hits_total"
    aff0 = counter_total(st, name)
    hs = [env.router.submit(prompt(i)) for i in range(3)]
    assert [h.replica_id for h in hs] == [0, 0, 1]
    assert counter_total(st, name) - aff0 == 1
    drive(env)
    assert all(h.state == st.SV.RequestState.DONE for h in hs)
    assert hs[2].stream.result() == greedy_ref(prompt(2), 4)
    return summary(env, hs)


@scenario
def ejected_replica_never_receives_traffic(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1,
                                    "probe_cooldown_s": 1e9})
    env.replicas[0].kill()
    h_dead = env.router.submit(ids(1, 7))
    assert h_dead.replica_id == 0
    env.router.step(env.params)
    env.clock.advance(0.05)
    assert env.replicas[0].health.state == st.SV.ReplicaState.EJECTED
    hs = [env.router.submit(ids(i, i + 6)) for i in range(1, 6)]
    assert all(h.replica_id == 1 for h in hs)
    drive(env)
    assert h_dead.state == st.SV.RequestState.DONE
    assert h_dead.replica_id == 1
    assert all(h.state == st.SV.RequestState.DONE for h in hs)
    return summary(env, [h_dead] + hs)


@scenario
def half_open_probe_admits_exactly_one(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1,
                                    "probe_cooldown_s": 0.2})
    S = st.SV.ReplicaState
    env.replicas[0].stall(0.15)
    h0 = env.router.submit(ids(1, 7))
    env.router.step(env.params)
    env.clock.advance(0.05)
    assert env.replicas[0].health.state == S.EJECTED
    env.clock.advance(0.3)
    env.router.step(env.params)
    assert env.replicas[0].health.state == S.HALF_OPEN
    probes = [env.router.submit(ids(i, i + 6)) for i in range(1, 4)]
    assert [h.replica_id for h in probes].count(0) == 1
    assert probes[0].replica_id == 0
    drive(env)
    assert env.replicas[0].health.state == S.HEALTHY
    assert all(h.state == st.SV.RequestState.DONE for h in probes)
    h_after = env.router.submit(ids(9, 15))
    assert h_after.replica_id in (0, 1)
    drive(env)
    return summary(env, [h0] + probes + [h_after])


@scenario
def failed_probe_reejects_with_doubled_cooldown(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1,
                                    "probe_cooldown_s": 0.2})
    S = st.SV.ReplicaState
    env.replicas[0].kill()
    h0 = env.router.submit(ids(1, 7))
    env.router.step(env.params)
    env.clock.advance(0.3)
    env.router.step(env.params)
    assert env.replicas[0].health.state == S.HALF_OPEN
    h = env.router.submit(ids(2, 8))
    assert h.replica_id == 0
    env.router.step(env.params)
    env.clock.advance(0.05)
    assert env.replicas[0].health.state == S.EJECTED
    assert env.replicas[0].health.cooldown_s == pytest.approx(0.4)
    drive(env)
    assert h.state == st.SV.RequestState.DONE and h.replica_id == 1
    return summary(env, [h0, h])


@scenario
def mid_stream_failover_byte_identical(st):
    env = fleet(st, n=2, max_new=6, health_kw={"eject_after": 2,
                                               "probe_cooldown_s": 1e9})
    p = ids(3, 8)
    h = env.router.submit(p)
    assert h.replica_id == 0
    for _ in range(4):
        env.router.step(env.params)
        env.clock.advance(0.05)
        if h.stream.tokens:
            break
    streamed = len(h.stream.tokens)
    assert 0 < streamed < 6
    env.replicas[0].kill()
    drive(env)
    assert h.state == st.SV.RequestState.DONE
    assert h.replica_id == 1 and h.failovers == 1
    assert h.stream.result() == greedy_ref(p, 6)
    return summary(env, [h], streamed=streamed)


@scenario
def fully_delivered_request_salvaged_not_failed(st):
    env = fleet(st, n=2, router_kw={"max_failovers": 0})
    h = env.router.submit(ids(1, 7), max_new_tokens=2)
    h.stream.push(11)
    h.stream.push(22)
    env.router._failover(h, 0, "died before finish callback")
    assert h.state == st.SV.RequestState.DONE
    assert h.stream.result() == [11, 22]
    assert env.router.failed_total == 0
    env2 = fleet(st, n=2, eos=99, router_kw={"max_failovers": 3})
    h2 = env2.router.submit(ids(1, 7), max_new_tokens=6)
    h2.stream.push(42)
    h2.stream.push(99)
    env2.router._failover(h2, 0, "died before finish callback")
    assert h2.state == st.SV.RequestState.DONE
    assert h2.stream.result() == [42, 99]
    return dict(first=summary(env, [h]), second=summary(env2, [h2]))


@scenario
def graceful_drain_hands_queued_to_siblings(st):
    env = fleet(st, n=2, num_slots=1, router_kw={"load_band": 8})
    RS = st.SV.RequestState
    rng = np.random.RandomState(23)
    base = rng.randint(1, env.cfg.vocab_size, (8,)).astype(np.int32)
    hs = [env.router.submit(np.concatenate([base, [i + 1]])
                            .astype(np.int32)) for i in range(3)]
    assert all(h.replica_id == 0 for h in hs)
    env.router.step(env.params)
    env.clock.advance(0.05)
    running = [h for h in hs if h.handle.state == RS.RUNNING]
    queued = [h for h in hs if h.handle.state == RS.QUEUED]
    assert len(running) == 1 and len(queued) == 2
    env.router.drain(0)
    assert all(h.replica_id == 1 for h in queued)
    assert running[0].replica_id == 0
    h_new = env.router.submit(np.concatenate([base, [9]]).astype(np.int32))
    assert h_new.replica_id == 1
    drive(env)
    assert all(h.state == RS.DONE for h in hs + [h_new])
    assert running[0].replica_id == 0 and running[0].failovers == 0
    assert env.router.statusz()["replicas"]["0"]["draining"] is True
    env.router.undrain(0)
    assert env.router.fleet_health() == "ok"
    return summary(env, hs + [h_new])


@scenario
def drain_handoff_exempt_from_sibling_queue_cap(st):
    env = fleet(st, n=2, num_slots=1, sched_kw={"max_queue_depth": 1})
    RS = st.SV.RequestState
    rng = np.random.RandomState(27)
    ps = [rng.randint(1, env.cfg.vocab_size, (6,)).astype(np.int32)
          for _ in range(4)]
    h0 = env.router.submit(ps[0])
    h1 = env.router.submit(ps[1])
    env.router.step(env.params)
    env.clock.advance(0.05)
    h2 = env.router.submit(ps[2])
    h3 = env.router.submit(ps[3])
    assert h2.replica_id == 0 and h3.replica_id == 1
    env.router.drain(0)
    assert h2.replica_id == 1
    drive(env)
    assert h2.state == RS.DONE and h3.state == RS.SHED
    assert all(h.state == RS.DONE for h in (h0, h1))
    return summary(env, [h0, h1, h2, h3])


@scenario
def drain_of_half_open_replica_releases_probe_slot(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1,
                                    "probe_cooldown_s": 0.2})
    env.replicas[0].stall(0.15)
    h0 = env.router.submit(ids(1, 7))
    env.router.step(env.params)
    env.clock.advance(0.3)
    env.router.step(env.params)
    h_probe = env.router.submit(ids(2, 8))
    assert h_probe.replica_id == 0
    env.router.drain(0)
    assert h_probe.replica_id == 1
    drive(env)
    assert h_probe.state == st.SV.RequestState.DONE
    env.router.undrain(0)
    h_new = env.router.submit(ids(3, 9))
    assert h_new.replica_id == 0
    drive(env)
    assert env.replicas[0].health.state == st.SV.ReplicaState.HEALTHY
    return summary(env, [h0, h_probe, h_new])


@scenario
def router_index_capped_with_lru_eviction(st):
    env = fleet(st, n=1, router_kw={"index_max_nodes": 2})
    rng = np.random.RandomState(29)
    hs = [env.router.submit(rng.randint(1, env.cfg.vocab_size, (8,))
                            .astype(np.int32)) for _ in range(4)]
    drive(env)
    nodes = env.router.statusz()["index_nodes"]["0"]
    assert nodes <= 2
    return summary(env, hs, index_nodes=nodes)


@scenario
def run_finishing_on_final_step_does_not_raise(st):
    env = fleet(st, n=1)
    h = env.router.submit(ids(1, 5))
    probe = fleet(st, n=1)
    probe.router.submit(ids(1, 5))
    steps_needed = 0
    while probe.router.pending:
        probe.router.step(env.params)
        steps_needed += 1
    env.router.run(env.params, max_steps=steps_needed)
    return summary(env, [h], steps_needed=steps_needed)


@scenario
def scheduler_degrade_treated_as_replica_death(st):
    env = fleet(st, n=2, sched_kw={"max_step_retries": 0},
                health_kw={"probe_cooldown_s": 1e9})
    h = env.router.submit(ids(1, 7))
    assert h.replica_id == 0
    env.router.step(env.params)
    env.clock.advance(0.05)

    def always_fail(p):
        raise RuntimeError("persistent device fault")

    env.replicas[0].engine.step = always_fail
    drive(env)
    assert env.replicas[0].degraded
    assert env.replicas[0].health.state == st.SV.ReplicaState.EJECTED
    assert h.state == st.SV.RequestState.DONE and h.replica_id == 1
    assert h.stream.result() == greedy_ref(ids(1, 7), 4)
    return summary(env, [h])


@scenario
def all_replicas_down_parks_then_recovers(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1,
                                    "probe_cooldown_s": 0.2})
    env.replicas[0].stall(0.15)
    env.replicas[1].stall(0.15)
    name = "paddle_router_failovers_total"
    fo0 = counter_total(st, name)
    h0 = env.router.submit(ids(1, 7))
    env.router.step(env.params)
    env.clock.advance(0.05)
    assert env.router.fleet_health() == "breached"
    h1 = env.router.submit(ids(2, 8))
    assert h1.replica_id is None
    assert env.router.statusz()["parked"] >= 1
    env.clock.advance(0.3)
    env.router.step(env.params)
    assert env.router.fleet_health() == "degraded"
    drive(env)
    assert h0.state == h1.state == st.SV.RequestState.DONE
    assert env.router.fleet_health() == "ok"
    assert counter_total(st, name) - fo0 == h0.failovers
    return summary(env, [h0, h1])


@scenario
def parked_request_deadline_beats_late_recovery(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1,
                                    "probe_cooldown_s": 0.2})
    env.replicas[0].stall(0.05)
    env.replicas[1].stall(0.05)
    h0 = env.router.submit(ids(1, 7))
    env.router.step(env.params)
    env.clock.advance(0.05)
    h1 = env.router.submit(ids(2, 8), deadline_ms=100)
    assert h1.replica_id is None
    env.clock.advance(0.5)
    env.router.step(env.params)
    assert h1.state == st.SV.RequestState.SHED
    assert h1.stream.finish_reason == "shed:deadline"
    drive(env)
    assert h0.state == st.SV.RequestState.DONE
    return summary(env, [h0, h1])


@scenario
def wedged_replica_trips_watchdog_and_fails_over(st):
    env = fleet(st, n=2, health_kw={"suspect_after": 1, "eject_after": 2,
                                    "watchdog_s": 0.2,
                                    "probe_cooldown_s": 1e9})
    h = env.router.submit(ids(1, 7))
    assert h.replica_id == 0
    env.replicas[0].engine.step = lambda params: 0
    drive(env, dt=0.15)
    assert env.replicas[0].health.state == st.SV.ReplicaState.EJECTED
    assert "watchdog" in env.replicas[0].health.last_failure
    assert h.state == st.SV.RequestState.DONE and h.replica_id == 1
    assert h.stream.result() == greedy_ref(ids(1, 7), 4)
    return summary(env, [h])


@scenario
def health_tracker_state_machine(st):
    clock = FakeClock()
    S = st.SV.ReplicaState
    t = st.SV.HealthTracker(st.SV.HealthConfig(
        suspect_after=1, eject_after=3, probe_cooldown_s=1.0,
        cooldown_multiplier=2.0), clock=clock)
    trail = []
    assert t.state == S.HEALTHY and t.accepting
    t.record_failure("boom")
    assert t.state == S.SUSPECT and t.accepting
    t.record_success()
    assert t.state == S.HEALTHY
    for _ in range(3):
        t.record_failure("boom")
    assert t.state == S.EJECTED and not t.accepting
    trail.append(t.snapshot())
    clock.advance(0.5)
    assert t.tick() == S.EJECTED
    clock.advance(0.6)
    assert t.tick() == S.HALF_OPEN
    t.record_success()
    assert t.state == S.HALF_OPEN
    t.record_failure("probe died")
    assert t.state == S.EJECTED and t.cooldown_s == pytest.approx(2.0)
    trail.append(t.snapshot())
    clock.advance(2.1)
    assert t.tick() == S.HALF_OPEN
    t.record_probe_success()
    assert t.state == S.HEALTHY and t.cooldown_s == pytest.approx(1.0)
    trail.append(t.snapshot())
    return dict(trail=trail)


@scenario
def health_tracker_watchdog(st):
    clock = FakeClock()
    S = st.SV.ReplicaState
    t = st.SV.HealthTracker(st.SV.HealthConfig(
        suspect_after=1, eject_after=2, watchdog_s=1.0), clock=clock)
    t.record_success()
    clock.advance(0.5)
    assert not t.check_watchdog(busy=True)
    clock.advance(1.0)
    assert not t.check_watchdog(busy=False)
    assert t.check_watchdog(busy=True)
    assert t.state == S.SUSPECT
    assert not t.check_watchdog(busy=True)
    clock.advance(1.1)
    assert t.check_watchdog(busy=True)
    assert t.state == S.EJECTED
    clock.advance(t.cooldown_s + 0.1)
    assert t.tick() == S.HALF_OPEN
    assert not t.check_watchdog(busy=True)
    assert t.state == S.HALF_OPEN
    clock.advance(1.5)
    assert t.check_watchdog(busy=True)
    assert t.state == S.EJECTED
    return dict(snapshot=t.snapshot())


@scenario
def fault_injector_replica_scoped_events(st):
    Fault, FaultInjector = st.RS.Fault, st.RS.FaultInjector
    inj = FaultInjector(schedule=[Fault("replica_die", 3, replica=1),
                                  Fault("replica_stall", 2)])
    assert not inj.fire("replica_die", 3, replica=0)
    assert not inj.fire("replica_die", 2, replica=1)
    assert inj.fire("replica_die", 3, replica=1)
    assert not inj.fire("replica_die", 3, replica=1)
    assert inj.fire("replica_stall", 2, replica=0)
    assert not inj.fire("replica_stall", 2, replica=1)
    assert inj.fired == [("replica_die", 3, 1), ("replica_stall", 2, 0)]
    inj2 = FaultInjector(schedule=[Fault("step_error", 5, replica=2)])
    assert not inj2.fire("step_error", 5)
    assert inj2.fire("step_error", 5, replica=2)
    a = FaultInjector.seeded_replicas(7, 20, 4)
    b = FaultInjector.seeded_replicas(7, 20, 4)
    assert a.schedule == b.schedule and a.schedule
    seeded = []
    for seed in range(16):
        sched = FaultInjector.seeded_replicas(seed, 3, 2, n_faults=6)
        assert all(1 <= f.step <= 3 for f in sched.schedule)
        assert len(set(sched.schedule)) == len(sched.schedule) == 6
        seeded.append([f.as_dict() for f in sched.schedule])
    tiny = FaultInjector.seeded_replicas(0, 1, 1, events=("replica_die",),
                                         n_faults=5)
    assert len(tiny.schedule) == 1
    return dict(fired=inj.fired,
                records=inj.fired_records + inj2.fired_records,
                seeded=seeded, json=a.to_json(),
                back=FaultInjector.from_json(a.to_json()).to_json())


def chaos_trace(st, inject, speculative=False):
    """The reference's ``_chaos_trace``: one 4-replica fleet, 12 requests
    on a fixed step schedule, optionally a replica death mid-decode and
    a stall."""
    injector = None
    if inject:
        injector = st.RS.FaultInjector(schedule=[
            st.RS.Fault("replica_die", 3, replica=1),
            st.RS.Fault("replica_stall", 5, replica=2)])
    env = fleet(st, n=4, max_new=8, num_slots=2, chunk=2,
                health_kw={"suspect_after": 1, "eject_after": 2,
                           "probe_cooldown_s": 0.4},
                router_kw={"failover_backoff_s": 0.05, "stall_s": 0.5},
                injector=injector, speculative=speculative)
    monitor = env.router.make_slo_monitor(completion_target=0.95,
                                          min_events=1)
    rng = np.random.RandomState(31)
    base = rng.randint(1, env.cfg.vocab_size, (4,)).astype(np.int32)
    prompts = []
    for i in range(12):
        if i % 3 == 0:
            tail = rng.randint(1, env.cfg.vocab_size, (3,))
            prompts.append(np.concatenate([base, tail]).astype(np.int32))
        else:
            n = int(rng.randint(4, 9))
            prompts.append(rng.randint(1, env.cfg.vocab_size, (n,))
                           .astype(np.int32))
    submissions = {0: prompts[:8], 6: prompts[8:10], 16: prompts[10:]}
    handles = []
    step = 0
    while step < 300:
        for p in submissions.pop(step, []):
            handles.append(env.router.submit(p))
        if not submissions and not env.router.pending:
            break
        env.router.step(env.params)
        env.clock.advance(0.05)
        step += 1
    assert step < 300, env.router.statusz()
    outputs = [h.stream.result() for h in handles]
    return SimpleNamespace(env=env, outputs=outputs, prompts=prompts,
                           monitor=monitor, handles=handles,
                           injector=injector, steps=step)


def _chaos_checks(st, run):
    RS, S = st.SV.RequestState, st.SV.ReplicaState
    router = run.env.router
    assert all(h.state == RS.DONE for h in run.handles)
    assert all(h.stream.finished for h in run.handles)
    for i in (0, 3):
        assert run.outputs[i] == greedy_ref(run.prompts[i], 8)
    assert router.failed_total == 0 and router.shed_total == 0
    assert not run.monitor.breached() and run.monitor.health() == "ok"
    assert router.replicas[1].health.state in (S.EJECTED, S.HALF_OPEN)
    assert not router.replicas[1].health.accepting
    assert router.replicas[2].health.state == S.HEALTHY


@scenario
def chaos_fleet_byte_identical_acceptance(st):
    clean = chaos_trace(st, inject=False)
    chaos = chaos_trace(st, inject=True)
    assert chaos.outputs == clean.outputs
    _chaos_checks(st, chaos)
    return summary(chaos.env, chaos.handles, fired=chaos.injector.fired,
                   steps=chaos.steps, slo=chaos.monitor.states())


@scenario
def chaos_fleet_green_with_speculation(st):
    clean = chaos_trace(st, inject=False, speculative=True)
    plain = chaos_trace(st, inject=True)
    chaos = chaos_trace(st, inject=True, speculative=True)
    assert chaos.outputs == clean.outputs == plain.outputs
    _chaos_checks(st, chaos)
    drafted = sum(r.engine.spec.stats["drafted"]
                  for r in chaos.env.router.replicas.values())
    assert drafted > 0
    return summary(chaos.env, chaos.handles, fired=chaos.injector.fired,
                   steps=chaos.steps, drafted=drafted)


@scenario
def infeasible_request_rejected_without_poisoning_breakers(st):
    env = fleet(st, n=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        env.router.submit(np.ones(40, np.int32))
    assert env.router.pending == 0
    assert all(r.health.state == st.SV.ReplicaState.HEALTHY
               for r in env.replicas)
    assert env.router.accepted_total == 0
    return summary(env, [])


@scenario
def diagserver_fleet_view(st):
    env = fleet(st, n=2)
    srv = st.O.DiagServer()
    srv.attach_router(env.router)
    view = srv.statusz()
    assert view["health"] == "ok"
    assert set(view["router"]["replicas"]) == {"0", "1"}
    env.replicas[0].kill()
    env.replicas[1].kill()
    h = env.router.submit(ids(1, 7))
    for _ in range(4):
        env.router.step(env.params)
        env.clock.advance(0.05)
    assert srv.health() == "breached"
    return summary(env, [h], health_after=srv.health())


@scenario
def replace_replica_reused_id_metrics_idempotent(st):
    env = fleet(st, n=2, speculative=True, health_kw={"eject_after": 1})
    RS = st.SV.RequestState
    for r in env.replicas:
        r.make_slo_monitor()
    h = [env.router.submit(ids(1, 6)) for _ in range(3)]
    drive(env)
    assert all(q.state == RS.DONE for q in h)
    reg = st.O.get_registry()
    old = reg.snapshot()["paddle_serving_r0"]["counters"][
        "requests_submitted_total"]
    assert old > 0
    for _cycle in range(2):
        env.router.replicas[0].kill()
        env.router.eject_replica(0, "test: chip torn")
        fresh = _handle(st, 0, env.clock, health_kw={"eject_after": 1},
                        speculative=True)
        env.router.replace_replica(fresh)
        fresh.make_slo_monitor()
    lines = [ln for ln in reg.prometheus_text().splitlines()
             if ln.startswith("paddle_serving_r0_requests_submitted_total")]
    assert lines == ["paddle_serving_r0_requests_submitted_total 0"], lines
    h2 = env.router.submit(ids(1, 6))
    drive(env)
    assert h2.state == RS.DONE
    assert sum(ln.startswith("paddle_serving_r0_requests_submitted_total")
               for ln in reg.prometheus_text().splitlines()) == 1
    return summary(env, h + [h2], old=old, lines=lines)


@scenario
def replace_replica_invalidates_affinity_index(st):
    env = fleet(st, n=2, health_kw={"eject_after": 1})
    shared = ids(1, 13)
    h = [env.router.submit(shared) for _ in range(2)]
    drive(env)
    assert all(q.state == st.SV.RequestState.DONE for q in h)
    warm = [rid for rid in env.router.replicas
            if env.router._overlap_tokens(rid, shared) > 0]
    assert warm
    victim = warm[0]
    assert env.router.statusz()["index_nodes"][str(victim)] > 0
    env.router.replicas[victim].kill()
    env.router.eject_replica(victim, "test: resize")
    env.router.replace_replica(_handle(st, victim, env.clock,
                                       health_kw={"eject_after": 1}))
    assert env.router._overlap_tokens(victim, shared) == 0
    assert env.router.statusz()["index_nodes"][str(victim)] == 0
    for rid in [r for r in env.router.replicas if r != victim]:
        env.router.invalidate_index(rid)
        assert env.router._overlap_tokens(rid, shared) == 0
    return summary(env, h, warm=warm)


# ---------------------------------------------------------------------------
# the parity test over every scenario
# ---------------------------------------------------------------------------

def quiet(st):
    """Every tap of the stack disarmed (an earlier test in the worker may
    have left one armed: an armed flight recorder dumps on ejection)."""
    for tap in (st.O.flight_recorder, st.O.span_collector, st.O.journal,
                st.O.memory_ledger):
        tap.disarm()
    st.O.flight_recorder.clear()


def _traced(st, fn, monkeypatch):
    quiet(st)
    events = []

    def emit(kind, **fields):
        if kind != "recompile":
            events.append((kind,) + tuple(
                (k, fields[k]) for k in EVENT_KEYS if k in fields))

    monkeypatch.setattr(st.EV.event_log, "emit", emit)
    # minted trace ids number from a process-global counter per package
    monkeypatch.setattr(st.O.trace, "_counter", itertools.count(1))
    out = fn(st)
    out["events"] = events
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_stack(name, monkeypatch):
    want = _traced(STACKS["jax"], SCENARIOS[name], monkeypatch)
    got = _traced(STACKS["torch"], SCENARIOS[name], monkeypatch)
    assert got == want


def test_router_families_match_the_catalog():
    """Every ``paddle_router_*`` family the port's router registers is
    declared in the port's catalog with the reference's kind and labels."""
    from paddle_tpu_torch.observability import catalog
    env = fleet(STACKS["torch"], n=1)
    env.router.submit(ids(1, 5))
    drive(env)
    fams = [n for n in TO.get_registry().snapshot()
            if n.startswith("paddle_router_")]
    assert fams
    for name in fams:
        assert catalog.declared_metric(name) is not None, name


def test_replica_stamps_its_id_into_the_spec_label():
    env = fleet(STACKS["torch"], n=2, speculative=True)
    assert [r.engine.spec.replica for r in env.replicas] == ["0", "1"]
