"""Multi-host serving smoke of the PyTorch port: serving survives losing
an engine PROCESS, against two REAL processes (the port's counterpart of
``scripts/multihost_serve_smoke.py``).

What it proves, end to end, in one run:

1. two engine processes (``paddle_tpu_torch.serving.multihost.
   llama_tiny_host``, spawned) behind a ``HostFleetRouter`` (every frame
   a versioned, checksummed wire message over a real pipe) serve a
   ragged storm; completions are recorded as the fault-free reference;
2. live migration mid-decode: ``migrate_host`` drains a host WITH its
   KV pages — export at src, checksummed transfer, import into the
   sibling's prefix cache — and the continuation finishes
   byte-identically, having prefilled only the un-migrated tail, under
   an armed telemetry federation (one merged trace tree, one merged
   ``/metrics`` document);
3. a seeded ``host_die`` (real SIGKILL) mid-decode: heartbeats stop,
   the health tracker walks SUSPECT -> EJECTED, every interrupted
   flight fails over and the storm completes byte-identical to the
   fault-free run with the fleet SLO un-breached and zero live pages
   left on the survivor.

Run: python scripts/multihost_serve_smoke_torch.py [--device cpu|cuda]
(``cuda``, the default, puts each host's engine on the card: its
kernels are built at first use; ``cpu`` runs the plain versions). Exit
0 = all assertions green.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from paddle_tpu_torch.observability.format import validate_exposition_text  # noqa: E402
from paddle_tpu_torch.observability.timeline import span_collector, timeline_armed  # noqa: E402
from paddle_tpu_torch.resilience import FaultInjector  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    HealthConfig, HostEndpoint, HostFleetRouter, HostHandle, PipeTransport,
    RouterConfig)

MAX_NEW = 10
VOCAB = 256          # prompt token range; well inside llama_tiny's vocab


def _spawn_host(i, device):
    kw = {"max_new_tokens": MAX_NEW, "max_seq_len": 48, "num_slots": 2,
          "device": device}
    if device == "cuda":
        kw["num_attention_heads"] = 1   # head dim 64: the card's kernels
    tr = PipeTransport(factory_kwargs=kw, host_id=i)
    ep = HostEndpoint(tr, timeout_s=300.0)
    return HostHandle(i, ep,
                      health_config=HealthConfig(suspect_after=1,
                                                 eject_after=2,
                                                 probe_cooldown_s=600.0))


def _drive(router, max_steps=5000, on_step=None):
    steps = 0
    while router.pending:
        router.step(None)
        steps += 1
        if on_step is not None:
            on_step(steps)
        assert steps < max_steps, "storm did not converge"
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where each host's engine runs (default: cuda)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, VOCAB,
                           (int(rng.randint(5, 11)),)).astype(np.int32)
               for _ in range(6)]

    hosts = [_spawn_host(i, args.device) for i in range(2)]
    router = HostFleetRouter(hosts, config=RouterConfig())
    monitor = router.make_slo_monitor(completion_target=0.99)
    try:
        # 1. fault-free reference storm over both processes
        refs = [router.submit(p) for p in prompts]
        _drive(router)
        ref = [list(h.stream.tokens) for h in refs]
        assert all(len(t) == MAX_NEW for t in ref)

        # 2. live migration mid-decode, pages included — under an ARMED
        # observability federation: every heartbeat ships a telemetry
        # frame back over the pipe, remote spans are skew-corrected into
        # the parent collector, and the migration must land in ONE
        # merged trace tree
        timeline_armed[0] = True
        router.federation.arm()
        router.step(None)         # prime: deliver arm=True to the hosts
        h = router.submit(prompts[0])
        for _ in range(4):
            router.step(None)
        src = h.replica_id
        mig = router.migrate_host(src)
        _drive(router)
        router.step(None)         # flush the final telemetry frames
        assert list(h.stream.tokens) == ref[0], \
            "migrated continuation diverged from the fault-free run"
        assert mig["requests"] == 1 and mig["failed"] == 0
        assert mig["pages"] >= 1 and mig["bytes"] > 0, mig
        router.undrain(src)

        # federated /metrics: ONE validator-clean exposition document
        # covering the parent and both engine processes
        fed_text = router.federation.federated_metrics_text()
        validate_exposition_text(fed_text)
        for lbl in ('host="parent"', 'host="h0"', 'host="h1"'):
            assert lbl in fed_text, f"federated doc is missing {lbl}"

        # merged cross-host trace: both hosts' spans in one tree, with
        # migration / dcn_transfer segments tiling the root envelope
        spans = span_collector.spans(h.trace_id)
        span_hosts = {s.args["host"] for s in spans
                      if s.args and "host" in s.args}
        assert span_hosts == {0, 1}, span_hosts
        tree = span_collector.tree(h.trace_id)
        assert len(tree) == 1, "expected ONE merged trace tree"
        att = span_collector.attribute(h.trace_id)
        segs = att["segments"]
        assert segs.get("migration", 0) > 0, segs
        assert segs.get("dcn_transfer", 0) > 0, segs
        tiling_err = abs(sum(segs.values()) - att["e2e_ms"])
        assert tiling_err <= 0.01 * att["e2e_ms"], (segs, att["e2e_ms"])
        mirrors = {hid: router.federation.mirror(hid) for hid in (0, 1)}
        assert all(m.frames > 0 and m.spans_merged > 0
                   for m in mirrors.values()), {
            hid: (m.frames, m.spans_merged) for hid, m in mirrors.items()}
        reconcile_ms = router.federation.reconcile_error_s() * 1e3

        # 3. seeded host death mid-decode (a real SIGKILL). seeded_hosts
        # schedules 1-based steps; rebase onto the router's live counter
        # so the kill lands a few steps into THIS storm.
        inj = FaultInjector.seeded_hosts(
            seed=23, num_steps=4, num_hosts=2, events=("host_die",))
        base = router._steps
        inj.schedule = [dataclasses.replace(f, step=f.step + base)
                        for f in inj.schedule]
        router.injector = inj
        storm = [router.submit(p) for p in prompts]
        _drive(router)
        assert inj.fired and inj.fired[0][0] == "host_die", inj.fired
        dead = inj.fired[0][2]
        got = [list(h.stream.tokens) for h in storm]
        assert got == ref, "host-kill storm diverged from fault-free run"
        assert not hosts[dead].endpoint.alive()
        assert hosts[1 - dead].endpoint.alive()
        failovers = sum(h.failovers for h in storm)

        # no SLO breach, nothing leaked, nothing unresolved
        assert monitor.health() == "ok", monitor.health()
        assert router.failed_total == 0 and router.shed_total == 0
        assert router.pending == 0 and router.parked == 0
        surv = hosts[1 - dead].statusz()["host"]
        assert surv["pages"]["live"] == 0, surv["pages"]
        assert surv["inflight"] == 0 and surv["queued"] == 0
        snap = router.multihost_snapshot()
        assert snap["migrations"], "migration timeline is empty"

        print(json.dumps({
            "smoke": "multihost_serve",
            "device": args.device,
            "requests": len(prompts),
            "byte_identical": True,
            "migration": {"pages": mig["pages"], "bytes": mig["bytes"],
                          "skipped_pages": mig["skipped_pages"],
                          "ms": round(mig["seconds"] * 1e3, 3)},
            "federation": {
                "trace_hosts": sorted(span_hosts),
                "migration_segment_ms": round(segs["migration"], 3),
                "dcn_transfer_segment_ms": round(segs["dcn_transfer"], 3),
                "tiling_err_ms": round(tiling_err, 6),
                "reconcile_error_ms": round(reconcile_ms, 3),
                "frames": {f"h{hid}": m.frames
                           for hid, m in mirrors.items()}},
            "seeded_kill": {"host": dead, "step": inj.fired[0][1] - base},
            "failovers": failovers,
            "slo": monitor.health(),
            "survivor_live_pages": surv["pages"]["live"],
            "wall_s": round(time.perf_counter() - t_start, 3),
        }))
        return 0
    finally:
        router.close()


if __name__ == "__main__":
    sys.exit(main())
