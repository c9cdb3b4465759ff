"""Postmortem replay in the port (``paddle_tpu_torch.observability.replay``)
on the CPU: the JAX package's replay scenarios (tests/test_journal.py,
the chaos-arc acceptance and the refusals) through the port's stack.

The 4-replica ejection incident runs once with the journal armed (module
fixture): its bundles validate, the final bundle replays byte-identically
with zero leaked pages, the mid-incident ejection bundle replays as a
clean prefix, planted divergences (a flipped token, a dropped chaos
frame) localize to the exact (step, replica, component), the CLI answers
with the reference's exit codes (0 ok, 1 divergence, 2 refused), and the
structural refusals give the reference's codes. A port run's head frame
is the JAX package's for the same configuration, and a bundle the JAX
package journaled replays in the port to a divergence at its first
outcome frame (the port draws other weights from the seed), not a
crash."""

import importlib
import io
import json
import os
import tarfile

import numpy as np
import pytest

from paddle_tpu_torch.inference.decoding import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.observability.flight import (BUNDLE_SCHEMAS,
                                                   BundleError,
                                                   flight_recorder,
                                                   validate_bundle)
from paddle_tpu_torch.observability.journal import (JournalError,
                                                    decode_journal,
                                                    encode_frames, journal,
                                                    model_spec,
                                                    token_checksum)
from paddle_tpu_torch.observability.replay import (main, replay_bundle,
                                                   replay_journal)
from paddle_tpu_torch.serving import (FleetRouter, HealthConfig,
                                      ReplicaHandle, RouterConfig,
                                      SchedulerConfig)
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

MAX_NEW = 8
SEED = 3
CFG = L.llama_tiny(num_hidden_layers=2)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    advance = sleep


def _chaos_fleet(S, D, injector, make_params, cfg, device_kw):
    """The reference test's 4-replica fleet, built from package ``S``
    (serving) and ``D`` (decoding)."""
    params = make_params()
    clock = _Clock()
    replicas = [
        S.ReplicaHandle(
            i,
            D.ContinuousBatchingEngine(
                cfg, D.GenerationConfig(max_new_tokens=MAX_NEW, seed=SEED),
                num_slots=2, page_size=4, max_seq_len=32, chunk=2,
                **device_kw),
            config=S.SchedulerConfig(max_step_retries=1,
                                     retry_backoff_s=0.01),
            health_config=S.HealthConfig(suspect_after=1, eject_after=2,
                                         probe_cooldown_s=0.4),
            clock=clock, sleep=clock.sleep)
        for i in range(4)]
    router = S.FleetRouter(
        replicas, config=S.RouterConfig(failover_backoff_s=0.05,
                                        stall_s=0.5),
        clock=clock, sleep=clock.sleep, fault_injector=injector)
    return params, router, clock


class _Port:
    ContinuousBatchingEngine = ContinuousBatchingEngine
    GenerationConfig = GenerationConfig
    FleetRouter, HealthConfig = FleetRouter, HealthConfig
    ReplicaHandle, RouterConfig = ReplicaHandle, RouterConfig
    SchedulerConfig = SchedulerConfig


def _run_incident(dump_dir, S, D, F, J, faults, make_params, cfg,
                  device_kw):
    """The journaled chaos run (replica 1 dies mid-decode at step 3,
    replica 2 stalls at step 5) with package ``S``/``D``/flight ``F``/
    journal module ``J``: the ejection auto-dump and a final bundle."""
    injector = faults.FaultInjector(schedule=[
        faults.Fault("replica_die", 3, replica=1),
        faults.Fault("replica_stall", 5, replica=2)])
    params, router, clock = _chaos_fleet(S, D, injector, make_params, cfg,
                                         device_kw)
    rng = np.random.RandomState(31)
    prompts = [rng.randint(1, cfg.vocab_size,
                           (int(rng.randint(4, 9)),)).astype(np.int32)
               for _ in range(12)]
    submissions = {0: prompts[:8], 6: prompts[8:10], 16: prompts[10:]}
    F.flight_recorder.clear()
    F.flight_recorder.arm(dump_dir=dump_dir)
    J.journal.arm(capacity=8192)
    J.journal.record_head(model=J.model_spec(cfg, SEED),
                          fleet=router.journal_topology())
    try:
        handles, step = [], 0
        while step < 300:
            for p in submissions.pop(step, []):
                handles.append(router.submit(p))
            if not submissions and not router.pending:
                break
            router.step(params)
            clock.advance(0.05)
            step += 1
        assert step < 300, router.statusz()
        final = F.flight_recorder.dump_debug_bundle(reason="test_final")
    finally:
        J.journal.disarm()
        F.flight_recorder.disarm()
    streams = [list(h.stream.result()) for h in handles]
    assert all(len(s) == MAX_NEW for s in streams)
    ejection = os.path.join(
        dump_dir,
        [f for f in os.listdir(dump_dir) if "replica_ejected" in f][0])
    return {"streams": streams, "ejection": ejection, "final": final,
            "fired": [dict(r) for r in injector.fired_records],
            "router": router}


@pytest.fixture(scope="module")
def incident(tmp_path_factory):
    import paddle_tpu_torch.observability.flight as F
    import paddle_tpu_torch.resilience.faults as faults
    J = importlib.import_module("paddle_tpu_torch.observability.journal")
    out = _run_incident(str(tmp_path_factory.mktemp("incident")), _Port,
                        _Port, F, J, faults,
                        lambda: L.init_params(CFG, seed=SEED, device="cpu"),
                        CFG, dict(device="cpu"))
    out["head"] = validate_bundle(out["final"])["journal"].head
    return out


def _rewrite_member(src_path, dst_path, name, data):
    """Copy a bundle tarball with one member's bytes replaced."""
    with tarfile.open(src_path, "r:gz") as src, \
            tarfile.open(dst_path, "w:gz") as dst:
        for m in src.getmembers():
            buf = src.extractfile(m).read()
            if os.path.basename(m.name) == name:
                buf = data
                m.size = len(buf)
            dst.addfile(m, io.BytesIO(buf))
    return dst_path


def _replay(path):
    return replay_bundle(path, device="cpu")


def test_incident_bundles_validate_and_stamp_every_member(incident):
    for path in (incident["ejection"], incident["final"]):
        doc = validate_bundle(path)
        svs = doc["manifest"]["schema_versions"]
        assert set(svs) == set(doc["members"])
        for name, ver in svs.items():
            assert ver == BUNDLE_SCHEMAS.get(name, ver)
        assert doc["journal"] is not None


def test_incident_journal_frames_carry_the_nondeterminism_frontier(incident):
    by_type = {}
    for f in validate_bundle(incident["final"])["journal"].frames:
        by_type.setdefault(f["t"], []).append(f)
    assert len(by_type["arrival"]) == 12
    for a in by_type["arrival"]:
        assert a["prompt_crc"] == token_checksum(a["prompt"])
    ids = [f["fault"]["id"] for f in by_type["fault"]]
    assert ids == [r["id"] for r in incident["fired"]]
    assert "replica_die@s3:r1:c-:h-" in ids
    walk = [(h["prev"], h["state"]) for h in by_type["health"]
            if h["replica"] == 1]
    assert ("suspect", "ejected") in walk
    assert len(by_type["outcome"]) == 12
    for o in by_type["outcome"]:
        assert o["stream_crc"] == token_checksum(o["tokens"])
        if o["engine_crc"] is not None and o["failovers"] == 0:
            assert o["engine_crc"] == o["stream_crc"]


def test_final_bundle_replays_byte_identical_with_zero_leaks(incident):
    rep = _replay(incident["final"])
    assert rep.refused is None, rep.refused
    assert rep.divergence is None, rep.divergence
    assert rep.ok
    assert rep.replicas == 4 and rep.arrivals == 12 and rep.outcomes == 12
    assert rep.pending == 0
    assert rep.leaked_pages == 0 and rep.conservation == "ok"


def test_ejection_bundle_replays_as_clean_prefix(incident):
    rep = _replay(incident["ejection"])
    assert rep.refused is None, rep.refused
    assert rep.divergence is None, rep.divergence
    assert rep.conservation == "ok"
    assert rep.pending > 0


def _doctored(incident, tmp_path, name, edit):
    decoded = validate_bundle(incident["final"])["journal"]
    frames = edit([dict(f) for f in decoded.frames])
    return _rewrite_member(incident["final"], str(tmp_path / name),
                           "journal.jsonl",
                           encode_frames(decoded.head, frames)), frames


def test_planted_flipped_token_localizes_to_exact_frame(incident, tmp_path):
    def flip(frames):
        target = next(f for f in frames if f["t"] == "outcome")
        target["tokens"] = list(target["tokens"])
        target["tokens"][0] ^= 1
        return frames

    path, frames = _doctored(incident, tmp_path, "flipped.tar.gz", flip)
    target = next(f for f in frames if f["t"] == "outcome")
    rep = _replay(path)
    d = rep.divergence
    assert d is not None and not rep.ok
    assert (d.step, d.replica, d.component) \
        == (target["step"], target["replica"], "outcome")
    assert d.journaled["tokens"] != d.observed["tokens"]


def test_dropped_chaos_frame_localizes_to_health_divergence(incident,
                                                           tmp_path):
    def drop(frames):
        frames = [f for f in frames
                  if not (f["t"] == "fault"
                          and f["fault"]["event"] == "replica_die")]
        for seq, f in enumerate(frames, start=1):
            f["seq"] = seq
        return frames

    path, _ = _doctored(incident, tmp_path, "dropped.tar.gz", drop)
    d = _replay(path).divergence
    assert d is not None
    assert d.component == "health" and d.replica == 1
    assert d.journaled["state"] == "suspect"


def test_replay_cli_reports_ok_and_divergence(incident, tmp_path, capsys):
    assert main([incident["final"], "--json", "--device", "cpu"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert body["ok"] and body["divergence"] is None

    def crc(frames):
        next(f for f in frames if f["t"] == "outcome")["stream_crc"] ^= 1
        return frames

    path, _ = _doctored(incident, tmp_path, "crc.tar.gz", crc)
    assert main([path, "--device", "cpu"]) == 1
    assert "divergence" in capsys.readouterr().out.lower()


def _journal_bytes(frames):
    return encode_frames({"model": None, "fleet": None}, frames)


def test_replay_refuses_scale_handoff_and_rotated_windows():
    scale = {"t": "scale", "seq": 1, "step": 2, "scale_seq": 1,
             "action": "scale_up", "reason": "queue", "replica": None,
             "role": None}
    rep = replay_journal(decode_journal(_journal_bytes([scale])),
                         device="cpu")
    assert rep.refused["code"] == "topology_changed"
    handoff = {"t": "handoff", "seq": 1, "step": 2, "rid": 0, "src": 0,
               "dst": 1, "pages": 3, "outcome": "ok"}
    rep = replay_journal(decode_journal(_journal_bytes([handoff])),
                         device="cpu")
    assert rep.refused["code"] == "disagg"
    step = {"t": "step", "seq": 5, "step": 5, "clock": 1.0}
    rep = replay_journal(decode_journal(_journal_bytes([step])),
                         device="cpu")
    assert rep.refused["code"] == "rotated"
    rep = replay_journal(decode_journal(encode_frames(
        {"model": None, "fleet": {"router_kind": "DisaggRouter"}}, [])),
        device="cpu")
    assert rep.refused["code"] == "topology"


def test_cli_refusal_exits_two(tmp_path, capsys):
    assert not journal.armed
    flight_recorder.clear()
    flight_recorder.arm(dump_dir=str(tmp_path))
    try:
        path = flight_recorder.dump_debug_bundle(reason="no_journal")
    finally:
        flight_recorder.disarm()
    assert _replay(path).refused["code"] == "no_journal"
    assert main([path, "--device", "cpu"]) == 2
    assert "REFUSED [no_journal]" in capsys.readouterr().out


def test_doctored_bundles_refuse_with_validator_codes(incident, tmp_path):
    doc = validate_bundle(incident["final"])
    manifest = json.loads(doc["members"]["manifest.json"])
    manifest["schema_versions"]["metrics.json"] = 99
    skew = _rewrite_member(incident["final"], str(tmp_path / "skew.tar.gz"),
                           "manifest.json",
                           json.dumps(manifest, indent=1).encode())
    with pytest.raises(BundleError):
        validate_bundle(skew)
    assert _replay(skew).refused["code"] == "bundle:version_skew"
    torn = _rewrite_member(incident["final"], str(tmp_path / "torn.tar.gz"),
                           "journal.jsonl",
                           doc["members"]["journal.jsonl"][:-9])
    with pytest.raises(JournalError):
        validate_bundle(torn)
    assert _replay(torn).refused["code"] == "journal:truncated"


def test_head_frame_is_the_reference_format(incident):
    """The model half of a port run's head frame equals the JAX
    package's for the same configuration (the dtype by its numpy name,
    not ``torch.float32``), and so does the fleet half, but for the
    engines' ``step_tokens``, which the port journals beside the
    reference's keys (replay needs the packed axis)."""
    import torch
    from paddle_tpu.models import llama as JL
    from paddle_tpu.observability.journal import model_spec as jmodel_spec
    import paddle_tpu.inference.decoding as JD
    import paddle_tpu.serving as JS
    head = incident["head"]
    assert head["model"] == jmodel_spec(
        JL.llama_tiny(num_hidden_layers=2), SEED)
    assert model_spec(L.llama_tiny(dtype=torch.bfloat16),
                      1)["config"]["dtype"] == "bfloat16"
    _, jrouter, _ = _chaos_fleet(
        JS, JD, None, lambda: None, JL.llama_tiny(num_hidden_layers=2), {})
    want = jrouter.journal_topology()
    got = json.loads(json.dumps(head["fleet"]))
    for spec in got["replicas"]:
        assert spec["engine"].pop("step_tokens") == 4
    assert got == json.loads(json.dumps(want))


def test_jax_journaled_bundle_diverges_at_its_first_outcome(tmp_path):
    """The JAX package's incident bundle, replayed by the port: the fleet
    and the chaos re-occur frame for frame, and the first divergence is
    the first outcome frame (other weights, other tokens)."""
    from paddle_tpu.models import llama as JL
    import paddle_tpu.inference.decoding as JD
    import paddle_tpu.observability.flight as JF
    import paddle_tpu.resilience.faults as jfaults
    import paddle_tpu.serving as JS
    JJ = importlib.import_module("paddle_tpu.observability.journal")
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    out = _run_incident(str(tmp_path), JS, JD, JF, JJ, jfaults,
                        lambda: JL.init_stacked_params(jcfg, seed=SEED),
                        jcfg, {})
    rep = _replay(out["final"])
    assert rep.refused is None, rep.refused
    d = rep.divergence
    assert d is not None and not rep.ok
    first = next(f for f in validate_bundle(out["final"])["journal"].frames
                 if f["t"] == "outcome")
    assert d.component == "outcome" and d.step == first["step"]
