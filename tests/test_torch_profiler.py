"""``paddle_tpu_torch.profiler`` (``Profiler``, the scheduler states, the
exporters, ``summary``/``SortedKeys``) against ``paddle_tpu.profiler``
on the CPU: the same scheduler gives the same states step by step, the
same program run under each package's profiler records the same span
names (the step spans, user ``RecordEvent`` spans and the dispatcher's op
spans) and exports chrome tracing with the reference's event fields and
file naming, the summary tables aggregate alike, and ``step_info``
reports the same fields. The device trace of a TPU/GPU/CUSTOM_DEVICE
target needs a card: on the host it raises (a stated difference, the
reference carries on without it); the card's trace is checked by the
``gpu``-marked tests and ``chip_smoke.py`` phase 40."""

import json
import os
import re
import time

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev
    TP.profiler.host_recorder.enabled = False
    TP.profiler.host_recorder.clear()


SCHEDULES = [dict(closed=1, ready=1, record=2, repeat=1, skip_first=1),
             dict(closed=0, ready=0, record=1),
             dict(closed=2, ready=1, record=3, repeat=2),
             dict(closed=0, ready=2, record=2, skip_first=3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[str(i) for i in
                                               range(len(SCHEDULES))])
def test_scheduler_states_match(kw):
    rs, ts = J.profiler.make_scheduler(**kw), TP.profiler.make_scheduler(**kw)
    assert [ts(i).name for i in range(25)] == [rs(i).name for i in range(25)]


def test_scheduler_rejects_what_the_reference_rejects():
    for kw in (dict(closed=-1, ready=0, record=1),
               dict(closed=0, ready=0, record=0)):
        for pkg in (J, TP):
            with pytest.raises(ValueError):
                pkg.profiler.make_scheduler(**kw)
    with pytest.raises(TypeError):
        TP.profiler.Profiler(scheduler="bad")


def _program(pkg, prof, steps):
    x = pkg.to_tensor(np.ones((4, 4), np.float32))
    for i in range(steps):
        with pkg.profiler.RecordEvent(f"user-{i}"):
            (x @ x).sum()
        (x + x).mean()
        prof.step(num_samples=4)


@pytest.mark.parametrize("sched", [None, (1, 3), "fn"])
def test_the_same_program_records_the_same_spans(sched, tmp_path):
    out = []
    for pkg in (J, TP):
        P = pkg.profiler
        s = (P.make_scheduler(closed=1, ready=1, record=2, repeat=1)
             if sched == "fn" else sched)
        exports = []

        def ready(prof, pkg_dir=str(tmp_path / pkg.__name__)):
            P.export_chrome_tracing(pkg_dir, worker_name="w")(prof)
            exports.append(prof.last_export_path)
        prof = P.Profiler(targets=[P.ProfilerTarget.CPU], scheduler=s,
                          on_trace_ready=ready)
        states = []
        prof.start()
        for i in range(5):
            states.append(prof.current_state.name)
            _program(pkg, prof, 1)
        prof.stop()
        names = sorted(sp.name for sp in prof.collected_spans)
        out.append((states, names, exports,
                    [json.load(open(p))["traceEvents"] for p in exports]))
    (rs, rn, rx, rev), (ts, tn, tx, tev) = out
    assert ts == rs
    assert tn == rn
    assert len(tx) == len(rx)
    for rp, tp_, re_, te in zip(rx, tx, rev, tev):
        assert re.fullmatch(r"w_time_\d+\.paddle_trace\.json",
                            os.path.basename(tp_))
        assert os.path.basename(rp).split("_time_")[0] == \
            os.path.basename(tp_).split("_time_")[0]
        assert sorted(e["name"] for e in te) == sorted(e["name"] for e in re_)
        for e in te:
            assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert {e["cat"] for e in te} == {e["cat"] for e in re_}


def test_trace_ids_give_flow_events(tmp_path):
    """Spans sharing a trace id carry ``args.trace_id`` and are chained
    by flow events, as the reference exports them."""
    out = []
    for pkg in (J, TP):
        from importlib import import_module
        rec = import_module(f"{pkg.__name__}.profiler.record")
        P = pkg.profiler
        prof = P.Profiler(scheduler=(0, 1))
        prof.start()
        t0 = time.perf_counter_ns()
        for i in range(3):
            rec.emit_span(f"stage{i}", t0 + i * 1000, t0 + i * 1000 + 500,
                          trace_id="req-7", args={"request_id": 7})
        prof.stop()
        P.export_chrome_tracing(str(tmp_path / pkg.__name__))(prof)
        evs = json.load(open(prof.last_export_path))["traceEvents"]
        out.append(sorted((e["name"], e["ph"], e.get("args", {})
                           .get("trace_id")) for e in evs))
    assert out[1] == out[0]
    assert ("trace/req-7", "s", None) in out[1]


def test_summary_tables_aggregate_alike():
    out = []
    for pkg in (J, TP):
        rec = pkg.profiler.host_recorder
        rec.clear()
        rec.enabled = True
        for d in (1, 2, 3):
            with pkg.profiler.RecordEvent("alpha"):
                time.sleep(d * 1e-3)
        with pkg.profiler.RecordEvent("beta"):
            time.sleep(5e-3)
        rec.enabled = False
        spans = rec.drain()
        rows = {}
        for key in pkg.profiler.SortedKeys:
            text = pkg.profiler.summary(spans, sorted_by=key, time_unit="us")
            lines = text.splitlines()
            rows[key.name] = ([ln.split()[0] for ln in lines[2:]],
                              [int(ln.split()[1]) for ln in lines[2:]],
                              lines[0].split())
        agg = pkg.profiler.profiler_statistic.aggregate(spans)
        out.append((rows, {k: v.count for k, v in agg.items()}))
    assert out[1][1] == out[0][1] == {"alpha": 3, "beta": 1}
    for key in out[0][0]:
        assert out[1][0][key][1:] == out[0][0][key][1:]
        assert out[1][0][key][0] == out[0][0][key][0]


def test_step_info_and_timer_only():
    infos = []
    for pkg in (J, TP):
        prof = pkg.profiler.Profiler(timer_only=True)
        assert prof.step_info() == "no steps recorded"
        prof.start()
        for _ in range(3):
            time.sleep(2e-3)
            prof.step(num_samples=32)
        infos.append(prof.step_info())
        prof.stop()
        assert prof.collected_spans == []
    pat = r"avg batch_cost: [\d.]+ ms, ips: [\d.]+ samples/s"
    assert all(re.fullmatch(pat, i) for i in infos)


def test_export_protobuf_writes_the_host_export(tmp_path):
    prof = TP.profiler.Profiler(scheduler=(0, 2), on_trace_ready=(
        TP.profiler.export_protobuf(str(tmp_path), "pb")))
    with prof:
        _program(TP, prof, 3)
    assert os.path.basename(prof.last_export_path).startswith("pb_time_")
    assert prof.summary().splitlines()[0].split()[0] == "Name"


@pytest.mark.parametrize("target", ["GPU", "TPU", "CUSTOM_DEVICE"])
def test_device_trace_without_a_card_raises(target, monkeypatch):
    """A device target asks for the card's trace; on the host it raises
    before any span is recorded, where the reference carries on with host
    spans only (the stated difference)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P = TP.profiler
    prof = P.Profiler(targets=[P.ProfilerTarget.CPU,
                               getattr(P.ProfilerTarget, target)],
                      scheduler=(0, 2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        prof.start()
    assert not P.host_recorder.enabled
