"""Deterministic postmortem replay: re-execute a debug bundle's journal
and localize the first divergence — counterpart of
``paddle_tpu/observability/replay.py``.

::

    python -m paddle_tpu_torch.observability.replay <bundle.tar.gz>

The bundle's ``journal.jsonl`` (:mod:`.journal`) records the complete
nondeterminism frontier of a fleet run — model geometry, fleet
topology, request arrivals with resolved sampler seeds, per-step clock
samples, consumed chaos faults, health transitions and terminal
outcomes. This module rebuilds the fleet from the head frame (the same
``LlamaConfig`` and the weights ``models.llama.init_params`` draws from
its seed), re-drives the step loop from the journaled arrivals/clock/
chaos, and verifies:

* **frame-sequence match** — every journaled frame re-occurs, in
  order, with an identical canonical payload (this subsumes the
  event-sequence and health-transition checks);
* **byte-identical token streams** — ``outcome`` frames carry the full
  stream tokens + crc32, so a single flipped token surfaces as a
  localized divergence, not a silent pass;
* **page conservation** — every replica pool's books balance after the
  drive, and a fully drained replay leaks zero pages.

On mismatch the report names the *first divergence* — (step, replica,
component, journaled-vs-observed) — instead of a wall of diffs. A
bundle dumped mid-incident (e.g. a ``replica_ejected_*`` auto-dump)
journals a prefix of the run; replay completes the step in flight, so
observed frames extending past the journal are expected, and in-flight
requests remain ``pending`` rather than failing the replay.

Weights come from the port's own seeded draw on the replaying device
(``device=None``: the card; the CLI runs there), so a bundle replays
bit for bit where the port journaled it, on that device type. A bundle
the JAX package journaled (``init_stacked_params`` draws other bits)
replays to its first outcome frame and is reported there as a
divergence.

Structured refusals (exit code 2) instead of wrong answers: a rotated
ring (arrivals evicted), a non-``FleetRouter`` topology, autoscale
topology changes or disagg handoffs mid-window, and grammar arrivals
without a journaled vocab all refuse with a code — replay never
guesses at inputs it does not have.

NOTE: replay drives the PROCESS-global journal recorder (the taps it
verifies write there). In-process callers must snapshot their own
journal (``journal.encode()``) before calling :func:`replay_bundle`.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .journal import (DecodedJournal, Divergence, JournalError,
                      decode_journal, first_divergence, journal)


class ReplayRefused(Exception):
    """The bundle is structurally un-replayable; ``code`` says why."""

    def __init__(self, code: str, detail: str = ""):
        self.code = code
        self.detail = detail
        super().__init__(f"replay refused ({code}): {detail}")

    def as_dict(self) -> Dict[str, str]:
        return {"code": self.code, "detail": self.detail}


@dataclass
class ReplayReport:
    """The replay verdict; ``as_dict`` is the CLI's ``--json`` body."""

    bundle: str
    ok: bool
    refused: Optional[Dict[str, str]] = None
    replicas: int = 0
    steps: int = 0
    arrivals: int = 0
    outcomes: int = 0
    pending: int = 0
    leaked_pages: int = 0
    conservation: str = "ok"
    divergence: Optional[Divergence] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "bundle": self.bundle, "ok": self.ok,
            "refused": self.refused, "replicas": self.replicas,
            "steps": self.steps, "arrivals": self.arrivals,
            "outcomes": self.outcomes, "pending": self.pending,
            "leaked_pages": self.leaked_pages,
            "conservation": self.conservation,
            "divergence": (None if self.divergence is None
                           else self.divergence.as_dict()),
        }


class ReplayClock:
    """A settable injected clock: the drive loop pins it to each
    journaled sample; intra-step sleeps advance it exactly as the
    original fake clock's did."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def set(self, t: float) -> None:
        self.t = float(t)

    def sleep(self, dt: float) -> None:
        self.t += float(dt)


# -- reconstruction ----------------------------------------------------------

def rebuild_model(head: Dict[str, Any], *, device=None):
    """(cfg, params) from the head frame's ``model_spec``: the dtype
    resolved from its name, the weights ``init_params`` draws from the
    journaled seed on ``device``."""
    import torch
    from ..models import llama as L
    m = head.get("model") or {}
    arch = m.get("arch")
    ctor = getattr(L, str(arch), None)
    if ctor is None:
        raise ReplayRefused("model", f"unknown model arch {arch!r}")
    kwargs = dict(m.get("config") or {})
    if "dtype" in kwargs:
        dt = getattr(torch, str(kwargs["dtype"]), None)
        if not isinstance(dt, torch.dtype):
            raise ReplayRefused(
                "model", f"unresolvable dtype {kwargs['dtype']!r}")
        kwargs["dtype"] = dt
    cfg = ctor(**kwargs)
    params = L.init_params(cfg, seed=int(m.get("params_seed", 0)),
                           device=device)
    return cfg, params


def rebuild_injector(frames: List[Dict[str, Any]]):
    """A :class:`FaultInjector` whose schedule is exactly the journaled
    consumed faults — replay re-fires what fired, nothing else."""
    from ..resilience.faults import Fault, FaultInjector
    sched = []
    for f in frames:
        if f.get("t") != "fault":
            continue
        rec = f.get("fault") or {}
        sched.append(Fault(
            event=str(rec.get("event")), step=int(rec.get("step", 0)),
            replica=rec.get("replica"), chip=rec.get("chip"),
            host=rec.get("host"), delay_s=rec.get("delay_s")))
    return FaultInjector(schedule=sched) if sched else None


def rebuild_fleet(head: Dict[str, Any], clock: ReplayClock, injector, *,
                  device=None):
    """The fleet from the head frame's ``journal_topology``, its engines
    on ``device``."""
    from ..inference.decoding import (ContinuousBatchingEngine,
                                      GenerationConfig)
    from ..serving import (FleetRouter, HealthConfig, ReplicaHandle,
                           RouterConfig, SchedulerConfig)

    fleet = head.get("fleet") or {}
    kind = fleet.get("router_kind")
    if kind != "FleetRouter":
        raise ReplayRefused(
            "topology", f"router_kind={kind!r} is not replayable yet "
                        "(only single-process FleetRouter fleets)")
    specs = fleet.get("replicas") or []
    if not specs:
        raise ReplayRefused("topology", "head frame names no replicas")
    cfg, params = rebuild_model(head, device=device)
    replicas = []
    for spec in specs:
        e = spec.get("engine") or {}
        eng = ContinuousBatchingEngine(
            cfg, GenerationConfig(**(spec.get("generation") or {})),
            num_slots=int(e["num_slots"]), page_size=int(e["page_size"]),
            max_seq_len=int(e["max_seq_len"]),
            num_pages=int(e["num_pages"]), chunk=int(e["chunk"]),
            prefix_cache=bool(e.get("prefix_cache", False)),
            speculative=bool(e.get("speculative", False)),
            spec_k=int(e.get("spec_k") or 4),
            unified=bool(e.get("unified", True)),
            step_tokens=e.get("step_tokens"), device=device)
        replicas.append(ReplicaHandle(
            int(spec["replica_id"]), eng,
            config=SchedulerConfig(**(spec.get("scheduler") or {})),
            health_config=HealthConfig(**(spec.get("health") or {})),
            clock=clock, sleep=clock.sleep))
    router = FleetRouter(
        replicas, config=RouterConfig(**(fleet.get("config") or {})),
        clock=clock, sleep=clock.sleep, fault_injector=injector)
    return cfg, params, router, replicas


def _rebuild_sampler(payload: Optional[Dict[str, Any]]):
    if payload is None:
        return None
    from ..inference.sampling import SamplerConfig
    return SamplerConfig(**payload)


def _rebuild_grammar(payload: Optional[Dict[str, Any]],
                     head: Dict[str, Any], eos: Optional[int]):
    if payload is None:
        return None
    vocab = (head.get("model") or {}).get("vocab")
    if vocab is None:
        raise ReplayRefused(
            "grammar", "journal has grammar-constrained arrivals but "
                       "the head frame carries no vocab")
    from ..inference.constrain import compile_regex
    dfa = compile_regex(str(payload.get("pattern")), vocab,
                        eos_token_id=payload.get("eos_token_id", eos))
    want = payload.get("fingerprint")
    if want is not None and getattr(dfa, "fingerprint", None) != want:
        raise ReplayRefused(
            "grammar", f"recompiled DFA fingerprint "
                       f"{getattr(dfa, 'fingerprint', None)!r} != "
                       f"journaled {want!r}")
    return dfa


# -- the drive ---------------------------------------------------------------

def _refuse_unreplayable(decoded: DecodedJournal) -> None:
    if decoded.dropped:
        raise ReplayRefused(
            "rotated", f"journal ring evicted {decoded.dropped} leading "
                       "frames — arrivals are incomplete; re-arm with a "
                       "larger capacity")
    for f in decoded.frames:
        t = f.get("t")
        if t == "scale":
            raise ReplayRefused(
                "topology_changed",
                f"autoscale record {f.get('scale_seq')} "
                f"({f.get('action')}) changed the fleet mid-window")
        if t == "handoff":
            raise ReplayRefused(
                "disagg", "disagg KV handoffs in window — DisaggRouter "
                          "replay is not supported yet")


def replay_journal(decoded: DecodedJournal, bundle: str = "<journal>",
                   *, device=None) -> ReplayReport:
    """Re-execute a decoded journal on ``device`` (None: the card); see
    the module docstring for the verification contract."""
    report = ReplayReport(bundle=bundle, ok=False)
    try:
        _refuse_unreplayable(decoded)
        clock = ReplayClock()
        injector = rebuild_injector(decoded.frames)
        cfg, params, router, replicas = rebuild_fleet(
            decoded.head, clock, injector, device=device)
    except ReplayRefused as e:
        report.refused = e.as_dict()
        return report
    report.replicas = len(replicas)
    eos = router.replicas[next(iter(router.replicas))] \
        .engine.config.eos_token_id

    # record with the very taps being verified: the process journal
    journal.arm(capacity=max(4 * len(decoded.frames) + 64, 4096))
    journal.record_head(**decoded.head)
    try:
        for f in decoded.frames:
            t = f.get("t")
            if t == "step":
                clock.set(float(f["clock"]))
                router.step(params)
                report.steps += 1
            elif t == "arrival":
                clock.set(float(f["clock"]))
                try:
                    grammar = _rebuild_grammar(f.get("grammar"),
                                               decoded.head, eos)
                except ReplayRefused as e:
                    report.refused = e.as_dict()
                    return report
                router.submit(
                    np.asarray(f["prompt"], np.int32),
                    priority=int(f.get("priority", 0)),
                    deadline_ms=f.get("deadline_ms"),
                    max_new_tokens=int(f["budget"]),
                    sampler=_rebuild_sampler(f.get("sampler")),
                    grammar=grammar)
                report.arrivals += 1
            elif t == "outcome":
                report.outcomes += 1
            # fault/health/admit/wire frames are outputs: the re-drive
            # regenerates them and the frame diff below judges them
        observed = decode_journal(journal.encode())
    finally:
        journal.disarm()

    report.divergence = first_divergence(decoded.frames, observed.frames)
    report.pending = router.pending
    leaked = 0
    conservation = "ok"
    for rid in sorted(router.replicas):
        eng = router.replicas[rid].engine
        check = getattr(eng.mgr, "check_conservation", None)
        if check is not None:
            try:
                check()
            except Exception as e:
                conservation = f"replica {rid}: {e!r}"
        if report.pending == 0 and eng.cache is None:
            # fully drained and no prefix cache holding retired pages:
            # every page must be back on the free list
            leaked += (int(eng.mgr.usable_pages)
                       - int(eng.mgr.num_free_pages))
    report.leaked_pages = leaked
    report.conservation = conservation
    report.ok = (report.divergence is None and leaked == 0
                 and conservation == "ok")
    return report


def replay_bundle(path: str, *, device=None) -> ReplayReport:
    """Validate + replay one debug-bundle tarball on ``device`` (None:
    the card)."""
    from .flight import BundleError, validate_bundle
    try:
        doc = validate_bundle(path)
    except BundleError as e:
        return ReplayReport(bundle=path, ok=False,
                            refused={"code": f"bundle:{e.code}",
                                     "detail": e.detail})
    except JournalError as e:
        return ReplayReport(bundle=path, ok=False,
                            refused={"code": f"journal:{e.code}",
                                     "detail": e.detail})
    decoded = doc.get("journal")
    if decoded is None:
        return ReplayReport(
            bundle=path, ok=False,
            refused={"code": "no_journal",
                     "detail": "bundle has no journal.jsonl — was the "
                               "journal armed when it was dumped?"})
    return replay_journal(decoded, bundle=path, device=device)


# -- CLI ---------------------------------------------------------------------

def _format_report(r: ReplayReport) -> str:
    lines = [f"replay: {r.bundle}"]
    if r.refused is not None:
        lines.append(f"  REFUSED [{r.refused['code']}] "
                     f"{r.refused['detail']}")
        return "\n".join(lines)
    lines.append(
        f"  fleet: {r.replicas} replicas; drove {r.steps} steps, "
        f"{r.arrivals} arrivals, {r.outcomes} journaled outcomes")
    lines.append(
        f"  pending at journal end: {r.pending}; leaked pages: "
        f"{r.leaked_pages}; conservation: {r.conservation}")
    if r.divergence is None:
        lines.append("  OK — byte-identical re-execution, every "
                     "journaled frame reproduced in order")
    else:
        d = r.divergence
        lines.append(
            f"  FIRST DIVERGENCE at step {d.step}, replica {d.replica}, "
            f"component {d.component} (frame {d.index}):")
        lines.append(f"    journaled: {json.dumps(d.journaled)}")
        lines.append(f"    observed:  {json.dumps(d.observed)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.replay",
        description="Re-execute a debug bundle's black-box journal and "
                    "report the first divergence, if any.")
    ap.add_argument("bundle", help="debug bundle tarball (.tar.gz)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--device", default=None,
                    help="where to replay (default: the card)")
    args = ap.parse_args(argv)
    try:
        report = replay_bundle(args.bundle, device=args.device)
    except JournalError as e:
        report = ReplayReport(bundle=args.bundle, ok=False,
                              refused={"code": f"journal:{e.code}",
                                       "detail": e.detail})
    if args.json:
        print(json.dumps(report.as_dict(), indent=1, default=str))
    else:
        print(_format_report(report))
    if report.ok:
        return 0
    return 2 if report.refused is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
