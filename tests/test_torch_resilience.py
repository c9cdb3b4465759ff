"""The fault-tolerant training runtime of the PyTorch port
(``paddle_tpu_torch.resilience`` over ``distributed.checkpoint``) against
the JAX package's on the CPU: every scenario of tests/test_resilience.py
but the launcher's ``Pod`` ones runs through both stacks from the same
weights (the JAX net's, carried across) and the same numpy batches.

The port is held to the reference's observable results: the metrics
counters, ``resumed_from``, ``skipped_steps``, ``end_step``, the steps
restored and committed, the faults fired and ``Preempted``'s step and
checkpoint. Its chaos run ends byte for byte on its own uninterrupted
run, and within ``trained_weights_close``'s fp32 bound of the
reference's (two stacks summing in other orders)."""

import importlib
import logging
import os
import re
import threading
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as TP
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _stack(name):
    """The modules of one package, and the reference test's helpers
    over them. The port's net takes the JAX net's weights at the same
    seed, so both stacks start alike."""
    ref = name == "ref"
    pkg = "paddle_tpu" if ref else "paddle_tpu_torch"

    def mod(m):
        return importlib.import_module(f"{pkg}.{m}")

    S = types.SimpleNamespace(
        ref=ref, P=paddle if ref else TP, R=mod("resilience"),
        C=mod("distributed.checkpoint"),
        U=mod("distributed.checkpoint.utils"),
        A=mod("distributed.checkpoint.async_save"),
        SS=mod("distributed.checkpoint.save_state_dict"),
        logger=f"{pkg}.resilience")

    def make_net(seed, sizes=(4, 8, 2), relu=True):
        paddle.seed(seed)
        layers = [jnn.Linear(sizes[0], sizes[1])]
        if relu:
            layers.append(jnn.ReLU())
        layers.append(jnn.Linear(sizes[1], sizes[2]))
        jnet = jnn.Sequential(*layers)
        if ref:
            return jnet
        tnet = tnn.Sequential(*[tnn.Linear(m.weight.shape[0],
                                           m.weight.shape[1])
                                if isinstance(m, jnn.Linear) else tnn.ReLU()
                                for m in layers])
        tnet.set_state_dict({k: np.asarray(v._value)
                             for k, v in jnet.state_dict().items()})
        return tnet

    def make_ts(seed=21, lr=1e-2):
        net = make_net(seed)
        opt = (jopt if ref else topt).AdamW(learning_rate=lr,
                                            parameters=net.parameters())
        return net, opt, S.C.TrainState(net, opt)

    def step_fn(net, opt, injector=None):
        def step(i):
            if injector is not None and injector.fire("nan", i):
                return float("nan")
            x = S.P.to_tensor(
                np.random.RandomState(1000 + i).randn(8, 4).astype(np.float32))
            loss = (net(x) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step

    def params(net):
        return [np.array(p._value if ref else p.detach().numpy())
                for p in net.parameters()]

    def param_bytes(net):
        return [a.tobytes() for a in params(net)]

    def trainer(tmp_path, net, opt, ts, **kw):
        kw.setdefault("save_interval", 5)
        kw.setdefault("keep", 3)
        kw.setdefault("retry_backoff", 0.001)
        cfg = S.R.ResilienceConfig(checkpoint_dir=str(tmp_path / "ckpts"),
                                   **kw)
        return S.R.ResilientTrainer(ts, cfg)

    def reference_run(tmp_path, num_steps, seed=21):
        net, opt, ts = make_ts(seed)
        tr = trainer(tmp_path / "ref", net, opt, ts)
        res = tr.run(step_fn(net, opt), num_steps)
        return net, res

    S.make_net, S.make_ts, S.step_fn = make_net, make_ts, step_fn
    S.params, S.param_bytes, S.trainer = params, param_bytes, trainer
    S.reference_run = reference_run
    return S


@pytest.fixture(params=["ref", "port"])
def both(request):
    return _stack(request.param)


def _through_both(tmp_path, scenario):
    """``scenario(stack, dir)`` through both packages: (reference's
    observables, port's observables)."""
    out = []
    for name in ("ref", "port"):
        d = tmp_path / name
        d.mkdir()
        out.append(scenario(_stack(name), d))
    return out


def _weights_close(got, want, lr, steps, msg):
    trained_weights_close(
        {str(i): torch.from_numpy(a) for i, a in enumerate(got)},
        {str(i): torch.from_numpy(a) for i, a in enumerate(want)},
        lr, steps, msg=msg)


# ---------------------------------------------------------------------------
# atomic write and checksums
# ---------------------------------------------------------------------------

def test_atomic_write_and_crc(tmp_path, both):
    U = both.U
    path = str(tmp_path / "blob")
    crc = U.atomic_write(path, lambda f: f.write(b"hello durable world"))
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    assert crc == U.file_crc32(path)
    U.verify_crc32(path, crc)
    with open(path, "r+b") as f:  # bitrot
        f.truncate(4)
    with pytest.raises(U.CheckpointCorruptError):
        U.verify_crc32(path, crc)


def test_atomic_write_failure_preserves_old_file(tmp_path, both):
    U = both.U
    path = str(tmp_path / "blob")
    U.atomic_write(path, lambda f: f.write(b"generation one"))

    def boom(f):
        f.write(b"gener")  # torn write, then the process "dies"
        raise IOError("disk died")

    with pytest.raises(IOError):
        U.atomic_write(path, boom)
    with open(path, "rb") as f:
        assert f.read() == b"generation one"


def test_sync_save_crash_leaves_previous_checkpoint_intact(
        tmp_path, monkeypatch, both):
    S = both
    net, _, _ = S.make_ts()
    ck = str(tmp_path / "ck")
    S.C.save_state_dict(net.state_dict(), ck)
    want = S.param_bytes(net)

    def torn_savez(f, **payload):
        f.write(b"PK\x03\x04 half a zip")
        raise IOError("crash mid-save")

    monkeypatch.setattr(S.SS.np, "savez", torn_savez)
    zeros = np.zeros((4, 8), np.float32)
    if S.ref:
        net[0].weight.set_value(zeros)
    else:
        net[0].set_state_dict({"weight": zeros})
    with pytest.raises(IOError):
        S.C.save_state_dict(net.state_dict(), ck)
    monkeypatch.undo()

    net2, _, _ = S.make_ts(seed=99)
    target = net2.state_dict()
    S.C.load_state_dict(target, ck)
    net2.set_state_dict(target)
    assert S.param_bytes(net2) == want


def test_load_rejects_truncated_shard(tmp_path, both):
    S = both
    net, _, _ = S.make_ts()
    ck = str(tmp_path / "ck")
    S.C.save_state_dict(net.state_dict(), ck)
    S.R.FaultInjector().truncate_shard(ck)
    with pytest.raises(S.C.CheckpointCorruptError):
        S.C.load_state_dict(net.state_dict(), ck)


# ---------------------------------------------------------------------------
# AsyncSaveFuture: timeout and the writer's exception
# ---------------------------------------------------------------------------

def test_async_future_timeout_then_result(tmp_path, monkeypatch, both):
    A = both.A
    gate = threading.Event()
    real = A.save_state_dict

    def slow(sd, path, **kw):
        assert gate.wait(30)
        return real(sd, path, **kw)

    monkeypatch.setattr(A, "save_state_dict", slow)
    net, _, _ = both.make_ts()
    fut = A.async_save_state_dict(net.state_dict(), str(tmp_path / "a"))
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.05)
    gate.set()
    assert fut.result(timeout=30) == str(tmp_path / "a")
    assert fut.exception() is None


def test_async_future_propagates_writer_exception(tmp_path, monkeypatch,
                                                  both):
    A = both.A

    def fail(sd, path, **kw):
        raise IOError("quota exceeded")

    monkeypatch.setattr(A, "save_state_dict", fail)
    net, _, _ = both.make_ts()
    fut = A.async_save_state_dict(net.state_dict(), str(tmp_path / "b"))
    with pytest.raises(IOError, match="quota exceeded"):
        fut.result(timeout=30)
    assert isinstance(fut.exception(), IOError)
    with pytest.raises(IOError):
        fut.result(timeout=30)


# ---------------------------------------------------------------------------
# the durable checkpoint layer
# ---------------------------------------------------------------------------

def test_durable_save_latest_marker_and_gc(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        root = str(d / "ckpts")
        step_fn = S.step_fn(net, opt)
        for i in range(5):
            step_fn(i)
            ts.step()
            S.R.save_checkpoint(ts.state_dict(), root, step=ts.global_step,
                                keep=2)
        with open(os.path.join(root, "LATEST")) as f:
            latest = f.read().strip()
        net2, opt2, ts2 = S.make_ts(seed=99)
        restored = S.R.restore_train_state(ts2, root)
        assert S.param_bytes(net2) == S.param_bytes(net)
        return dict(kept=[s for s, _ in S.R.list_checkpoints(root)],
                    latest=S.R.latest_step(root), marker=latest,
                    restored=restored, global_step=ts2.global_step,
                    files=sorted(os.listdir(S.R.checkpoint_path(root, 5)))
                    ), S.params(net)

    (ref, ref_w), (port, port_w) = _through_both(tmp_path, scenario)
    assert ref == port == dict(
        kept=[4, 5], latest=5, marker="step_5", restored=5, global_step=5,
        files=["0_0.distcp.dtypes", "0_0.distcp.npz", "0_0.metadata"])
    _weights_close(port_w, ref_w, 1e-2, 5, "after 5 steps")


def test_restore_covers_optimizer_state_in_fresh_process(tmp_path, both):
    """Optimizer moments round-trip into a process that has not run a
    step yet: both continue one identical step to equal parameters."""
    S = both
    net, opt, ts = S.make_ts()
    step = S.step_fn(net, opt)
    for i in range(3):
        step(i)
        ts.step()
    root = str(tmp_path / "ckpts")
    S.R.save_checkpoint(ts.state_dict(), root, step=ts.global_step)

    net2, opt2, ts2 = S.make_ts(seed=99)
    assert S.R.restore_train_state(ts2, root) == 3
    S.step_fn(net, opt)(3)
    S.step_fn(net2, opt2)(3)
    assert S.param_bytes(net2) == S.param_bytes(net)


def test_corrupt_latest_falls_back_to_previous_intact(tmp_path, caplog):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        root = str(d / "ckpts")
        step = S.step_fn(net, opt)
        step(0)
        ts.step()
        S.R.save_checkpoint(ts.state_dict(), root, step=1)
        good = S.param_bytes(net)
        step(1)
        ts.step()
        S.R.save_checkpoint(ts.state_dict(), root, step=2)
        S.R.FaultInjector().truncate_shard(S.R.checkpoint_path(root, 2))
        metrics = S.R.ResilienceMetrics()
        net2, opt2, ts2 = S.make_ts(seed=99)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=S.logger):
            restored = S.R.restore_train_state(ts2, root, metrics)
        assert any("step_2" in r.message for r in caplog.records)
        assert S.param_bytes(net2) == good
        return dict(restored=restored, counters=metrics.counters)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["restored"] == 1
    assert port["counters"]["corrupt_checkpoints_skipped"] >= 1


def test_injected_write_failure_never_commits(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        root = str(d / "ckpts")
        fi = S.R.FaultInjector([S.R.Fault("write_fail", 1)])
        S.R.save_checkpoint(ts.state_dict(), root, step=0, fault_injector=fi)
        with pytest.raises(IOError, match="injected write failure"):
            S.R.save_checkpoint(ts.state_dict(), root, step=1,
                                fault_injector=fi)
        out = dict(latest=S.R.latest_step(root),
                   committed_1=os.path.isdir(S.R.checkpoint_path(root, 1)),
                   litter=any(n.startswith(".tmp_") for n in os.listdir(root)))
        S.R.gc_checkpoints(root, keep=4)
        out.update(litter_after_gc=any(n.startswith(".tmp_")
                                       for n in os.listdir(root)),
                   loaded=S.R.load_latest_checkpoint(ts.state_dict(), root),
                   fired=list(fi.fired))
        return out

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port == dict(latest=0, committed_1=False, litter=True,
                               litter_after_gc=False, loaded=0,
                               fired=[("write_fail", 1)])


def test_seeded_injector_is_reproducible():
    from paddle_tpu.resilience import FaultInjector as JFI
    from paddle_tpu_torch.resilience import FaultInjector as TFI
    a = TFI.seeded(7, num_steps=100)
    b = TFI.seeded(7, num_steps=100)
    assert a.schedule == b.schedule and len(a.schedule) == 4
    assert TFI.seeded(8, num_steps=100).schedule != a.schedule
    assert [(f.event, f.step) for f in a.schedule] == [
        (f.event, f.step) for f in JFI.seeded(7, num_steps=100).schedule]


# ---------------------------------------------------------------------------
# mid-epoch resume: the resumed run sees the batches an uninterrupted run
# would, the reference's
# ---------------------------------------------------------------------------

def test_mid_epoch_resume_sees_identical_batches(tmp_path):
    def scenario(S, d):
        io = importlib.import_module(
            "paddle_tpu.io" if S.ref else "paddle_tpu_torch.io")
        ds = io.TensorDataset([np.arange(32, dtype=np.float32).reshape(32, 1)])

        def make_loader():
            return io.DataLoader(ds, batch_size=4, shuffle=True)

        def rows(b):
            b = b[0] if isinstance(b, (list, tuple)) else b
            return np.asarray(b.numpy()).ravel().tolist()

        def batches_of_epoch(epoch):
            loader = make_loader()
            loader.batch_sampler.set_epoch(epoch)
            return [rows(b) for b in loader]

        ref = [(e, b) for e in range(2) for b in batches_of_epoch(e)]
        ts = S.C.TrainState()
        seen = []
        loader = make_loader()
        loader.batch_sampler.set_epoch(0)
        for b in loader:
            seen.append((0, rows(b)))
            ts.step()
        ts.next_epoch()
        loader = make_loader()
        loader.batch_sampler.set_epoch(1)
        it = iter(loader)
        for _ in range(3):
            seen.append((1, rows(next(it))))
            ts.step()
        root = str(d / "pos")
        S.R.save_checkpoint(ts.state_dict(), root, step=ts.global_step)

        ts2 = S.C.TrainState()
        target = ts2.state_dict()
        assert S.R.load_latest_checkpoint(target, root) == ts.global_step
        ts2.set_state_dict(target)
        assert (ts2.epoch, ts2.batch_in_epoch) == (1, 3)
        for b in ts2.skip_batches(make_loader()):
            seen.append((1, rows(b)))
        assert seen == ref
        return seen

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port


# ---------------------------------------------------------------------------
# ResilientTrainer
# ---------------------------------------------------------------------------

def _observe(res):
    return {k: res[k] for k in ("resumed_from", "end_step", "skipped_steps")}


def test_trainer_plain_run_and_autoresume(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        tr = S.trainer(d, net, opt, ts, save_interval=3)
        res = tr.run(S.step_fn(net, opt), 7)
        latest = S.R.latest_step(str(d / "ckpts"))
        net2, opt2, ts2 = S.make_ts(seed=99)
        tr2 = S.trainer(d, net2, opt2, ts2, save_interval=3)
        res2 = tr2.run(S.step_fn(net2, opt2), 10)
        ref_net, ref = S.reference_run(d, 10)
        assert S.param_bytes(net2) == S.param_bytes(ref_net)
        assert res2["last_loss"] == ref["last_loss"]
        return dict(first=_observe(res), latest=latest,
                    second=_observe(res2)), S.params(net2)

    (ref, ref_w), (port, port_w) = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["second"]["resumed_from"] == 7
    _weights_close(port_w, ref_w, 1e-2, 10, "after 10 steps")


def test_trainer_retries_transient_step_error(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        fi = S.R.FaultInjector([S.R.Fault("step_error", 2)])
        tr = S.trainer(d, net, opt, ts, fault_injector=fi)
        res = tr.run(S.step_fn(net, opt), 5)
        ref_net, _ = S.reference_run(d, 5)
        assert S.param_bytes(net) == S.param_bytes(ref_net)
        return dict(run=_observe(res), counters=tr.metrics.counters,
                    fired=list(fi.fired))

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["counters"]["step_retries"] == 1


def test_trainer_aborts_after_retry_budget(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        tr = S.trainer(d, net, opt, ts, max_step_retries=2)

        def always_boom(i):
            raise ValueError("hardware on fire")

        with pytest.raises(S.R.TrainingAborted) as ei:
            tr.run(always_boom, 3)
        return dict(reason=ei.value.reason, retries=ei.value.info["retries"],
                    step=ei.value.step, counters=tr.metrics.counters)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["reason"] == "step_failed_after_retries"
    assert port["retries"] == 2


def test_trainer_nan_rollback_replays_clean(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        fi = S.R.FaultInjector([S.R.Fault("nan", 3)])
        tr = S.trainer(d, net, opt, ts, save_interval=2, fault_injector=fi)
        res = tr.run(S.step_fn(net, opt, fi), 6)
        ref_net, ref = S.reference_run(d, 6)
        assert S.param_bytes(net) == S.param_bytes(ref_net)
        assert res["last_loss"] == ref["last_loss"]
        return dict(run=_observe(res), counters=tr.metrics.counters)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["counters"]["nan_rollbacks"] == 1


def test_trainer_skips_persistently_divergent_step(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        fi = S.R.FaultInjector([S.R.Fault("nan", 2)] * 3)
        tr = S.trainer(d, net, opt, ts, save_interval=1,
                       max_nan_rollbacks=2, fault_injector=fi)
        res = tr.run(S.step_fn(net, opt, fi), 4)
        return dict(run=_observe(res), counters=tr.metrics.counters)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["run"]["skipped_steps"] == [2]
    assert port["counters"]["nan_rollbacks"] == 3


def test_trainer_preemption_flushes_then_resumes(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        fi = S.R.FaultInjector([S.R.Fault("preempt", 3)])
        tr = S.trainer(d, net, opt, ts, fault_injector=fi)
        with pytest.raises(S.R.Preempted) as ei:
            tr.run(S.step_fn(net, opt), 8)
        assert os.path.isdir(ei.value.checkpoint)
        first = dict(step=ei.value.step,
                     checkpoint=os.path.basename(ei.value.checkpoint),
                     counters=dict(tr.metrics.counters))
        net2, opt2, ts2 = S.make_ts(seed=99)
        tr2 = S.trainer(d, net2, opt2, ts2)
        res = tr2.run(S.step_fn(net2, opt2), 8)
        ref_net, _ = S.reference_run(d, 8)
        assert S.param_bytes(net2) == S.param_bytes(ref_net)
        return dict(first=first, second=_observe(res))

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["first"]["step"] == 4 and port["second"]["resumed_from"] == 4
    assert port["first"]["counters"]["preempt_flushes"] == 1


def test_chaos_seed_scales_to_run_length(tmp_path):
    def scenario(S, d):
        num_steps = 12
        net, opt, ts = S.make_ts()
        tr = S.trainer(d, net, opt, ts, save_interval=3, chaos_seed=3)
        trainers, end, preemptions = [tr], None, 0
        for _ in range(6):
            t = trainers[-1]
            try:
                end = t.run(S.step_fn(net, opt), num_steps)["end_step"]
                break
            except S.R.Preempted:
                preemptions += 1
                net, opt, ts = S.make_ts(seed=99)
                trainers.append(S.trainer(
                    d, net, opt, ts, save_interval=3,
                    fault_injector=tr.cfg.fault_injector))
        fi = tr.cfg.fault_injector
        assert fi is not None and len(fi.fired) + len(fi.schedule) == 4
        assert all(s < num_steps for _, s in fi.fired)
        return dict(end=end, fired=sorted(fi.fired), preemptions=preemptions)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["end"] == 12


def test_preempt_flush_failure_reports_intact_checkpoint(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        fi = S.R.FaultInjector([S.R.Fault("preempt", 3),
                                S.R.Fault("write_fail", 4)])
        tr = S.trainer(d, net, opt, ts, fault_injector=fi)
        with pytest.raises(S.R.Preempted) as ei:
            tr.run(S.step_fn(net, opt), 8)
        assert os.path.isdir(ei.value.checkpoint)
        return dict(step=ei.value.step,
                    checkpoint=os.path.basename(ei.value.checkpoint),
                    counters=tr.metrics.counters)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port
    assert port["step"] == 4 and port["checkpoint"] == "step_0"
    assert port["counters"]["save_failures"] == 1


def test_final_save_failure_aborts_instead_of_lying(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        fi = S.R.FaultInjector([S.R.Fault("write_fail", 3)] * 2)
        tr = S.trainer(d, net, opt, ts, fault_injector=fi)
        with pytest.raises(S.R.TrainingAborted) as ei:
            tr.run(S.step_fn(net, opt), 3)
        return dict(reason=ei.value.reason, step=ei.value.step)

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port == dict(reason="final_save_failed", step=3)


def test_optimizer_positional_restore_with_overlapping_names():
    """Partially overlapping saved names resolve all or nothing by
    position, never by a mixed name/position binding, and a scrambled key
    order is put back by the names' counters; as in the reference (whose
    names are ``generated_tensor_<n>``, the port's ``param_<i>``)."""
    S = _stack("port")
    net = S.make_net(5, sizes=(4, 4, 4), relu=False)
    opt = topt.AdamW(learning_rate=1e-2, parameters=net.parameters())
    S.step_fn(net, opt)(0)
    sd = opt.state_dict()
    old = []
    for k in sd:
        name = k.rpartition(".")[0]
        if k not in ("@step", "LR_Scheduler") and name not in old:
            old.append(name)
    shifted = dict(zip(old, old[1:] + ["generated_tensor_999999"]))
    renamed = {}
    for k, v in sd.items():
        if k in ("@step", "LR_Scheduler"):
            renamed[k] = v
        else:
            name, _, slot = k.rpartition(".")
            renamed[f"{shifted[name]}.{slot}"] = v
    want = [sd[f"{n}.moment1"].clone() for n in old]
    for state in (renamed, dict(reversed(list(renamed.items())))):
        opt2 = topt.AdamW(learning_rate=1e-2, parameters=net.parameters())
        opt2.set_state_dict(state)
        for n, w in zip(opt2._names, want):
            assert torch.equal(opt2.state[n]["moment1"], w)


def test_metrics_prometheus_text(tmp_path):
    def scenario(S, d):
        net, opt, ts = S.make_ts()
        tr = S.trainer(d, net, opt, ts, save_interval=2)
        tr.run(S.step_fn(net, opt), 4)
        text = tr.metrics.to_prometheus_text()
        assert re.search(r"paddle_resilience_saves_total [1-9]", text)
        assert "paddle_resilience_save_latency_ms_count" in text
        assert tr.metrics.summary()["save_latency_ms"]["count"] >= 1
        return sorted(tr.metrics.counters), sorted(
            line.split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#"))

    ref, port = _through_both(tmp_path, scenario)
    assert ref == port


# ---------------------------------------------------------------------------
# chaos: a mid-save crash, a truncated shard, a NaN step and a preemption;
# auto-resume completes and the final state is byte-identical to an
# uninterrupted run at the same seed
# ---------------------------------------------------------------------------

def test_chaos_run_matches_uninterrupted_byte_identical(tmp_path, caplog):
    num_steps = 30

    def scenario(S, d):
        schedule = [S.R.Fault("write_fail", 10), S.R.Fault("truncate_shard", 15),
                    S.R.Fault("nan", 17), S.R.Fault("preempt", 25)]
        fi = S.R.FaultInjector(list(schedule))
        net, opt, ts = S.make_ts()
        tr = S.trainer(d / "chaos", net, opt, ts, fault_injector=fi)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=S.logger):
            with pytest.raises(S.R.Preempted) as ei:
                tr.run(S.step_fn(net, opt, fi), num_steps)
            assert sorted(fi.fired) == sorted((f.event, f.step)
                                              for f in schedule)
            assert any("step_15" in r.message for r in caplog.records
                       if "skipping unusable checkpoint" in r.message)
            first = dict(step=ei.value.step,
                         checkpoint=os.path.basename(ei.value.checkpoint),
                         counters=dict(tr.metrics.counters))
            net2, opt2, ts2 = S.make_ts(seed=99)
            tr2 = S.trainer(d / "chaos", net2, opt2, ts2, fault_injector=fi)
            res = tr2.run(S.step_fn(net2, opt2, fi), num_steps)
        ref_net, ref = S.reference_run(d, num_steps)
        assert S.param_bytes(net2) == S.param_bytes(ref_net)
        assert res["last_loss"] == ref["last_loss"]
        return dict(first=first, second=_observe(res),
                    counters=dict(tr2.metrics.counters)), S.params(net2)

    (ref, ref_w), (port, port_w) = _through_both(tmp_path, scenario)
    assert ref == port
    c = port["first"]["counters"]
    assert c["corrupt_checkpoints_skipped"] >= 1 and c["save_failures"] >= 1
    assert c["nan_rollbacks"] == 1 and c["preempt_flushes"] == 1
    assert port["second"] == dict(resumed_from=port["first"]["step"],
                                  end_step=num_steps, skipped_steps=[])
    _weights_close(port_w, ref_w, 1e-2, num_steps, "chaos run")
