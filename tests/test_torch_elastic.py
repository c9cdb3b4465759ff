"""Elastic mesh resize: the port's ``serving.ElasticServingController``
over fleets of tensor-parallel replicas, against ``test_elastic.py``.

Each case runs the reference test's fleet, ``FakeClock`` storm and
fault schedule through the port (replicas over serving meshes of CPU
chips, ``[torch.device("cpu")] * mp``; the JAX package's weights carried
across, fp32) and asserts what the reference test asserts. The tokens
must also equal the JAX fleet's fault-free storm of the same
configuration (run once a configuration, module-scoped)."""

import io
import json
import tarfile

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.inference.decoding import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu import serving as jserving
from paddle_tpu_torch.inference.decoding import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.observability.events import configure_event_log
from paddle_tpu_torch.observability.flight import flight_recorder
from paddle_tpu_torch.observability.memory import memory_ledger
from paddle_tpu_torch.parallel.mesh import ServingMesh, serving_mesh
from paddle_tpu_torch.resilience import Fault, FaultInjector
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import RequestState
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

JCFG = JL.llama_tiny(num_hidden_layers=2)
JPARAMS = JL.init_stacked_params(JCFG, seed=3)
CFG = L.llama_tiny(num_hidden_layers=2)
PARAMS = L.params_from_numpy({k: np.asarray(v) for k, v in JPARAMS.items()},
                             CFG, "cpu")
CPU = torch.device("cpu")


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def advance(self, dt):
        self.t += dt


def _factories(clock, max_new=8, speculative=False, prefix_cache=False,
               jax_side=False):
    S = jserving if jax_side else tserving

    def engine_factory(mesh):
        if jax_side:
            return JEngine(JCFG, JGen(max_new_tokens=max_new, seed=3),
                           num_slots=2, page_size=4, max_seq_len=64, chunk=2,
                           prefix_cache=prefix_cache,
                           speculative=speculative, mesh=mesh)
        return ContinuousBatchingEngine(
            CFG, GenerationConfig(max_new_tokens=max_new, seed=3),
            num_slots=2, page_size=4, max_seq_len=64, chunk=2,
            prefix_cache=prefix_cache, speculative=speculative, mesh=mesh,
            device="cpu" if mesh is None else None)

    def handle_factory(rid, eng):
        return S.ReplicaHandle(
            rid, eng,
            config=S.SchedulerConfig(max_step_retries=1,
                                     retry_backoff_s=0.01),
            health_config=S.HealthConfig(suspect_after=1, eject_after=2,
                                         probe_cooldown_s=0.4),
            clock=clock, sleep=clock.sleep)

    return engine_factory, handle_factory


def _elastic_fleet(n=4, mp=2, injector=None, max_new=8, speculative=False,
                   prefix_cache=False, jax_side=False):
    S = jserving if jax_side else tserving
    clock = FakeClock()
    engine_factory, handle_factory = _factories(
        clock, max_new=max_new, speculative=speculative,
        prefix_cache=prefix_cache, jax_side=jax_side)
    devs = jax.devices() if jax_side else [CPU] * 8
    mk = jmesh.serving_mesh if jax_side else serving_mesh
    handles = [handle_factory(
        i, engine_factory(mk(mp, devs[mp * i:mp * (i + 1)])))
        for i in range(n)]
    router = S.FleetRouter(
        handles, config=S.RouterConfig(failover_backoff_s=0.05),
        clock=clock, sleep=clock.sleep, fault_injector=injector)
    ctl = S.ElasticServingController(router, engine_factory, handle_factory,
                                     fault_injector=injector, clock=clock)
    return router, ctl, clock


def _prompts(n=12, seed=31):
    rng = np.random.RandomState(seed)
    base = rng.randint(1, CFG.vocab_size, (4,)).astype(np.int32)
    out = []
    for i in range(n):
        if i % 3 == 0:          # a third share a 4-token system prefix
            tail = rng.randint(1, CFG.vocab_size, (3,))
            out.append(np.concatenate([base, tail]).astype(np.int32))
        else:
            ln = int(rng.randint(4, 9))
            out.append(rng.randint(1, CFG.vocab_size, (ln,))
                       .astype(np.int32))
    return out


def _storm(router, ctl, clock, prompts, submissions=None, max_steps=400,
           params=PARAMS):
    """Drive the elastic fleet loop with a fixed submission schedule
    until every request AND every pending resize completes."""
    submissions = dict(submissions
                       or {0: prompts[:8], 6: prompts[8:10],
                           16: prompts[10:]})
    handles = []
    step = 0
    while step < max_steps:
        for p in submissions.pop(step, []):
            handles.append(router.submit(p))
        if not submissions and not router.pending and not ctl.resizing:
            break
        ctl.step(params)
        clock.advance(0.05)
        step += 1
    assert step < max_steps, router.statusz()
    return handles


_JAX_STORMS = {}


def _jax_fault_free(n=2, mp=2, n_prompts=12, subs=None, **kw):
    """The JAX fleet's fault-free storm of a configuration (once)."""
    key = (n, mp, n_prompts, repr(subs), tuple(sorted(kw.items())))
    if key not in _JAX_STORMS:
        prompts = _prompts(n_prompts)
        s = subs(prompts) if subs else None
        h = _storm(*_elastic_fleet(n=n, mp=mp, jax_side=True, **kw),
                   prompts, submissions=s, params=JPARAMS)
        _JAX_STORMS[key] = [h_.stream.tokens for h_ in h]
    return _JAX_STORMS[key]


def _fault_free(n=2, mp=2, n_prompts=12, subs=None, **kw):
    """The port's fault-free storm, held to the JAX fleet's."""
    prompts = _prompts(n_prompts)
    h0 = _storm(*_elastic_fleet(n=n, mp=mp, **kw), prompts,
                submissions=subs(prompts) if subs else None)
    ref = [h.stream.tokens for h in h0]
    assert ref == _jax_fault_free(n, mp, n_prompts, subs, **kw)
    return prompts, ref


def _all_at_0(prompts):
    return {0: prompts}


def _six_then_two(prompts):
    return {0: prompts[:6], 8: prompts[6:]}


# ---------------------------------------------------------------------------
# the two fault paths, deterministically
# ---------------------------------------------------------------------------

def test_chip_die_mid_decode_byte_identical():
    """Crash path: one chip of an mp=2 replica dies mid-decode; its
    flights fail over byte-identically, it re-shards to one chip and
    rejoins HEALTHY."""
    prompts, ref = _fault_free()
    inj = FaultInjector(schedule=[Fault("chip_die", 4, replica=0, chip=1)])
    router, ctl, clock = _elastic_fleet(n=2, injector=inj)
    h1 = _storm(router, ctl, clock, prompts)
    assert inj.fired == [("chip_die", 4, 0, 1)]
    assert all(h.state == RequestState.DONE for h in h1)
    assert [h.stream.tokens for h in h1] == ref
    assert router.replicas[0].engine.num_chips == 1
    assert router.replicas[0].engine.mesh.chips == (0,)
    assert router.replicas[0].health.accepting
    [rec] = ctl.resizes
    assert rec.kind == "die" and (rec.from_chips, rec.to_chips) == (2, 1)
    assert [p for p, _ in rec.phases] == [
        "chip_lost", "checkpointed", "ejected", "resharded", "rejoined"]
    assert rec.flights and all(f.prompt for f in rec.flights)
    assert any(f.pages > 0 and f.streamed for f in rec.flights)
    h2 = router.submit(prompts[0])
    while router.pending:
        ctl.step(PARAMS)
        clock.advance(0.05)
    assert h2.stream.tokens == ref[0]


def test_graceful_chip_retire_no_failovers():
    """Graceful path (chip_degraded): drain, in-flight streams finish in
    place, re-shard, undrain; no failovers."""
    prompts, ref = _fault_free()
    inj = FaultInjector(schedule=[
        Fault("chip_degraded", 4, replica=1, chip=0)])
    router, ctl, clock = _elastic_fleet(n=2, injector=inj)
    h1 = _storm(router, ctl, clock, prompts)
    assert [h.stream.tokens for h in h1] == ref
    assert all(h.failovers == 0 for h in h1)
    [rec] = ctl.resizes
    assert rec.kind == "degraded"
    assert [p for p, _ in rec.phases] == [
        "chip_lost", "draining", "drained", "resharded", "rejoined"]
    assert router.replicas[1].engine.num_chips == 1
    assert router.replicas[1].engine.mesh.chips == (1,)
    assert not router.replicas[1].draining


def test_single_chip_replica_rebuilds_in_place():
    """A 1-chip replica losing its only chip rebuilds in place."""
    prompts, ref = _fault_free(mp=1, n_prompts=6, subs=_all_at_0)
    inj = FaultInjector(schedule=[Fault("chip_die", 3, replica=0)])
    router, ctl, clock = _elastic_fleet(n=2, mp=1, injector=inj)
    h1 = _storm(router, ctl, clock, prompts,
                submissions=_all_at_0(prompts))
    assert [h.stream.tokens for h in h1] == ref
    [rec] = ctl.resizes
    assert (rec.from_chips, rec.to_chips) == (1, 1)


def test_chip_die_supersedes_pending_graceful_drain():
    """A chip_die while the same replica's graceful drain is pending
    cancels the pending record: one physical shrink (4 -> 2)."""
    prompts, ref = _fault_free(mp=4)
    inj = FaultInjector(schedule=[
        Fault("chip_degraded", 3, replica=0, chip=3),
        Fault("chip_die", 4, replica=0, chip=1),
    ])
    router, ctl, clock = _elastic_fleet(n=2, mp=4, injector=inj)
    before = get_registry().snapshot().get(
        "paddle_mesh_resizes_total", {}).get("replica=0", 0.0)
    h1 = _storm(router, ctl, clock, prompts)
    assert inj.fired == [("chip_degraded", 3, 0, 3), ("chip_die", 4, 0, 1)]
    assert [h.stream.tokens for h in h1] == ref
    assert not ctl.resizing
    assert router.replicas[0].engine.num_chips == 2
    assert router.replicas[0].engine.mesh.chips == (0, 2)
    degraded, die = ctl.resizes
    assert degraded.kind == "degraded" and not degraded.done
    assert degraded.phases[-1][0] == "superseded"
    assert die.kind == "die" and die.done
    assert (die.from_chips, die.to_chips) == (4, 2)
    after = get_registry().snapshot().get(
        "paddle_mesh_resizes_total", {}).get("replica=0", 0.0)
    assert after - before == 1.0
    h2 = router.submit(prompts[0])
    while router.pending:
        ctl.step(PARAMS)
        clock.advance(0.05)
    assert h2.stream.tokens == ref[0]


def test_duplicate_degraded_coalesces_into_pending_drain():
    """A second chip_degraded on a replica whose drain is pending
    coalesces into the pending arc."""
    prompts, ref = _fault_free(mp=4)
    inj = FaultInjector(schedule=[
        Fault("chip_degraded", 3, replica=0, chip=0),
        Fault("chip_degraded", 4, replica=0, chip=2),
    ])
    router, ctl, clock = _elastic_fleet(n=2, mp=4, injector=inj)
    before = get_registry().snapshot().get(
        "paddle_mesh_chip_faults_total", {}).get(
            "replica=0,kind=degraded", 0.0)
    h1 = _storm(router, ctl, clock, prompts)
    assert len(inj.fired) == 2
    assert [h.stream.tokens for h in h1] == ref
    assert all(h.failovers == 0 for h in h1)
    [rec] = ctl.resizes
    assert rec.kind == "degraded" and rec.done
    assert "coalesced" in [p for p, _ in rec.phases]
    assert (rec.from_chips, rec.to_chips) == (4, 2)
    after = get_registry().snapshot().get(
        "paddle_mesh_chip_faults_total", {}).get(
            "replica=0,kind=degraded", 0.0)
    assert after - before == 2.0


def test_engine_rejects_mesh_without_mp_axis():
    """A mesh without the engine's ``mp_axis`` fails at construction
    with the reference's error."""
    mesh = ServingMesh([CPU] * 2, axis_name="x")
    with pytest.raises(ValueError, match="no 'mp' axis"):
        ContinuousBatchingEngine(
            CFG, GenerationConfig(max_new_tokens=4, seed=3),
            num_slots=2, page_size=4, max_seq_len=64, chunk=2, mesh=mesh)
    from jax.sharding import Mesh
    with pytest.raises(ValueError, match="no 'mp' axis"):
        JEngine(JCFG, JGen(max_new_tokens=4, seed=3), num_slots=2,
                page_size=4, max_seq_len=64, chunk=2,
                mesh=Mesh(np.array(jax.devices()[:2]), ("x",)))


def test_replacement_controller_resize_bundles_still_dump(tmp_path):
    """A later controller's resize postmortems get past the flight
    recorder's once-per-reason latch (process-global arc numbers)."""
    prompts = _prompts(6)
    subs = {0: prompts}
    flight_recorder.arm(dump_dir=str(tmp_path / "bundles"))
    try:
        for round_ in range(2):
            inj = FaultInjector(schedule=[
                Fault("chip_die", 3, replica=0, chip=1)])
            router, ctl, clock = _elastic_fleet(n=2, injector=inj)
            _storm(router, ctl, clock, prompts, submissions=subs)
            assert len(ctl.resizes) == 1 and ctl.resizes[0].done
            bundles = sorted((tmp_path / "bundles").glob(
                "*mesh_resized_r0_*.tar.gz"))
            assert len(bundles) == round_ + 1, \
                "resize arc %d produced no new bundle" % (round_ + 1)
    finally:
        flight_recorder.disarm()


# ---------------------------------------------------------------------------
# chip-loss storm: the chaos acceptance run
# ---------------------------------------------------------------------------

def test_chip_loss_storm_chaos_acceptance(tmp_path):
    """4-replica mp=2 fleet under one die and one degraded chip: every
    request completes byte-identical to the fault-free run, no SLO
    breach, the mesh metrics and events tell the story, and the
    chip-loss bundle embeds the resize timeline."""
    prompts, ref = _fault_free(n=4)
    ev = tmp_path / "chip_chaos_events.jsonl"
    configure_event_log(str(ev))
    flight_recorder.arm(dump_dir=str(tmp_path / "bundles"))
    try:
        inj = FaultInjector(schedule=[
            Fault("chip_die", 4, replica=1, chip=0),
            Fault("chip_degraded", 7, replica=2, chip=1),
        ])
        router, ctl, clock = _elastic_fleet(n=4, injector=inj)
        monitor = router.make_slo_monitor(completion_target=0.95,
                                          min_events=1)
        handles = _storm(router, ctl, clock, prompts)
    finally:
        configure_event_log(None)
        flight_recorder.disarm()

    assert all(h.state == RequestState.DONE for h in handles)
    assert all(h.stream.finished for h in handles)
    assert [h.stream.tokens for h in handles] == ref
    assert router.failed_total == 0 and router.shed_total == 0
    assert not monitor.breached() and monitor.health() == "ok"
    assert not inj.schedule
    assert router.replicas[1].engine.num_chips == 1
    assert router.replicas[2].engine.num_chips == 1
    assert all(router.replicas[r].health.accepting for r in (1, 2))
    assert len(ctl.resizes) == 2 and all(r.done for r in ctl.resizes)

    events = [json.loads(ln) for ln in ev.read_text().splitlines()]
    lost = [e for e in events if e["kind"] == "chip_lost"]
    resized = [e for e in events if e["kind"] == "mesh_resized"]
    assert {(e["replica"], e["cause"]) for e in lost} == {
        (1, "die"), (2, "degraded")}
    assert {(e["replica"], e["from_chips"], e["to_chips"])
            for e in resized} == {(1, 2, 1), (2, 2, 1)}
    failovers = [e for e in events if e["kind"] == "failover"]
    assert failovers and not any(e.get("exhausted") for e in failovers)
    assert "slo_breach" not in {e["kind"] for e in events}
    snap = get_registry().snapshot()
    assert snap["paddle_mesh_chips"]["replica=1"] == 1.0
    assert snap["paddle_mesh_resizes_total"]["replica=2"] == 1.0
    assert snap["paddle_mesh_chip_faults_total"]["replica=1,kind=die"] \
        == 1.0

    bundles = sorted((tmp_path / "bundles").glob("*.tar.gz"))
    mesh_bundles = [b for b in bundles if "mesh_resized" in b.name]
    assert mesh_bundles
    with tarfile.open(mesh_bundles[-1]) as tar:
        names = tar.getnames()
        assert "elastic.json" in names and "fleet.json" in names
        el = json.load(io.TextIOWrapper(tar.extractfile("elastic.json")))
    assert el["resizes"] and el["chips"]
    arc = el["resizes"][0]
    assert [p["phase"] for p in arc["phases"]][0] == "chip_lost"
    assert [p["phase"] for p in arc["phases"]][-1] == "rejoined"
    die_arcs = [a for a in el["resizes"] if a["kind"] == "die"]
    assert die_arcs and die_arcs[0]["flights"]
    assert all(f["prompt_tokens"] > 0 and f["trace_id"]
               for f in die_arcs[0]["flights"])
    assert any(f["pages"] > 0 for f in die_arcs[0]["flights"])


# ---------------------------------------------------------------------------
# speculation + prefix cache across resize: no page leak
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speculative", [False, True])
def test_drain_failover_spec_prefix_across_chip_chaos(speculative):
    """Drain/undrain and mid-stream failover with speculation and the
    prefix cache under chip chaos: no page leaks across the resize (the
    conservation audit every step, the ledger's byte audit alongside),
    byte-identical to the fault-free run."""
    prompts, ref = _fault_free(n=3, speculative=speculative,
                               prefix_cache=True)
    memory_ledger.reset()
    memory_ledger.arm()
    try:
        inj = FaultInjector(schedule=[
            Fault("chip_die", 5, replica=0, chip=1),
            Fault("chip_degraded", 9, replica=2, chip=0),
        ])
        router, ctl, clock = _elastic_fleet(
            n=3, injector=inj, speculative=speculative, prefix_cache=True)
        handles = []
        submissions = {0: prompts[:8], 6: prompts[8:10], 16: prompts[10:]}
        step = 0
        while step < 400:
            for p in submissions.pop(step, []):
                handles.append(router.submit(p))
            if step == 3:
                router.drain(1)
            if step == 12:
                router.undrain(1)
            if not submissions and not router.pending \
                    and not ctl.resizing:
                break
            ctl.step(PARAMS)
            clock.advance(0.05)
            step += 1
        assert step < 400, router.statusz()
        audits = memory_ledger.audits
    finally:
        memory_ledger.disarm()
        memory_ledger.reset()

    assert all(h.state == RequestState.DONE for h in handles)
    assert [h.stream.tokens for h in handles] == ref
    assert audits > 0
    assert len(ctl.resizes) == 2
    for r in router.replicas.values():
        r.engine.mgr.check_conservation()
        assert not r.engine.mgr._tables
        if speculative:
            assert r.engine.spec is not None
    if speculative:
        drafted = sum(r.engine.spec.stats["drafted"]
                      for r in router.replicas.values())
        assert drafted > 0


# ---------------------------------------------------------------------------
# chip-scoped fault injector
# ---------------------------------------------------------------------------

def test_fault_injector_chip_scoped_events():
    from paddle_tpu.resilience import Fault as JFault
    from paddle_tpu.resilience import FaultInjector as JInjector
    fired = []
    for F, I in ((Fault, FaultInjector), (JFault, JInjector)):
        inj = I(schedule=[F("chip_die", 3, replica=1, chip=1),
                          F("chip_degraded", 2)])
        assert inj.fire_chip("chip_die", 3, replica=0) is None
        assert inj.fire_chip("chip_die", 2, replica=1) is None
        assert inj.fire_chip("chip_die", 3, replica=1) == 1
        assert inj.fire_chip("chip_die", 3, replica=1) is None
        assert inj.fire_chip("chip_degraded", 2, replica=0,
                             default_chip=7) == 7
        assert inj.fire_chip("chip_degraded", 2, replica=1) is None
        fired.append(inj.fired)
    assert fired[0] == fired[1] == [("chip_die", 3, 1, 1),
                                    ("chip_degraded", 2, 0, 7)]


def test_seeded_chip_storms_deterministic():
    """Same seed, same (event, step, replica, chip) quadruples as the
    reference's ``seeded_chips``."""
    from paddle_tpu.resilience import FaultInjector as JInjector

    def quads(inj):
        return [(f.event, f.step, f.replica, f.chip) for f in inj.schedule]
    a = FaultInjector.seeded_chips(7, 20, 4, 2, n_faults=3)
    b = FaultInjector.seeded_chips(7, 20, 4, 2, n_faults=3)
    assert quads(a) == quads(b) == quads(
        JInjector.seeded_chips(7, 20, 4, 2, n_faults=3))
    assert len(a.schedule) == 3
    for seed in range(12):
        s = FaultInjector.seeded_chips(seed, 5, 3, 4, n_faults=3)
        assert quads(s) == quads(JInjector.seeded_chips(seed, 5, 3, 4,
                                                        n_faults=3))
        assert all(1 <= f.step <= 5 for f in s.schedule)
        assert all(f.chip is not None and 0 <= f.chip < 4
                   for f in s.schedule)
        reps = [f.replica for f in s.schedule]
        assert len(set(reps)) == len(reps)
    tiny = FaultInjector.seeded_chips(0, 4, 2, 2, n_faults=9)
    assert len(tiny.schedule) == 2


def test_seeded_chip_storm_end_to_end_byte_identical():
    """The storm the smoke script runs: a seeded schedule through the
    controller ends byte-identical and fully re-sharded."""
    prompts, ref = _fault_free(n_prompts=8, subs=_six_then_two)
    inj = FaultInjector.seeded_chips(11, 10, 2, 2, n_faults=2)
    router, ctl, clock = _elastic_fleet(n=2, injector=inj)
    h1 = _storm(router, ctl, clock, prompts,
                submissions=_six_then_two(prompts))
    assert [h.stream.tokens for h in h1] == ref
    assert not inj.schedule and len(ctl.resizes) == 2
    assert all(r.done for r in ctl.resizes)
