"""The high-level API of ``paddle_tpu_torch`` (``Model``, the callbacks,
the progress bar, ``summary``) against ``paddle_tpu``'s on the CPU: the
same training history, evaluation, predictions, printed text and
VisualDL log from one seed through both packages; a ``Model.save`` of
the JAX package loading into the port; ``prepare(jit_compile=True)``
training through ``jit.TrainStep``; and the reference's own scenarios
(``tests/test_hapi.py``) run through the port."""

import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

import torch_scenarios

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


@pytest.fixture
def clock(monkeypatch):
    """A clock that advances 7 ms a reading (the progress bar's
    ``ms/step`` is then the same in both packages)."""
    t = [1000.0]

    def now():
        t[0] += 0.007
        return t[0]
    monkeypatch.setattr(time, "time", now)


def _np(t):
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _data(pkg, n, seed, inputs_only=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)

    class Xor(pkg.io.Dataset):
        def __getitem__(self, i):
            return x[i] if inputs_only else (x[i], y[i])

        def __len__(self):
            return n
    return Xor()


def _model(pkg, metrics=True, sched=None):
    pkg.seed(0)
    nn = pkg.nn
    net = nn.Sequential(nn.Linear(2, 16), nn.Tanh(), nn.Linear(16, 2))
    opt = pkg.optimizer.Adam(learning_rate=sched or 0.05,
                             parameters=net.parameters())
    model = pkg.Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(),
                  pkg.metric.Accuracy(topk=(1, 2)) if metrics else None)
    return model


def _both(fn):
    return fn(J), fn(TP)


def test_fit_evaluate_predict_history_match():
    def run(pkg):
        model = _model(pkg)
        hist = model.fit(_data(pkg, 64, 0), _data(pkg, 32, 1),
                         batch_size=16, epochs=3, verbose=0)
        ev = model.evaluate(_data(pkg, 32, 2), batch_size=16, verbose=0)
        pred = model.predict(_data(pkg, 8, 3, True), batch_size=4,
                             stack_outputs=True, verbose=0)
        return hist, ev, pred
    (rh, re_, rp), (ph, pe, pp) = _both(run)
    assert len(ph) == len(rh) == 3
    for r, p in zip(rh, ph):
        assert sorted(p) == sorted(r)
        for k in r:
            np.testing.assert_allclose(p[k], r[k], err_msg=k, **TOL)
    assert sorted(pe) == sorted(re_)
    for k in re_:
        np.testing.assert_allclose(pe[k], re_[k], err_msg=k, **TOL)
    np.testing.assert_allclose(pp[0], rp[0], **TOL)


def test_batch_paths_and_accumulation():
    x = np.random.RandomState(4).randn(8, 2).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)

    def run(pkg):
        m = _model(pkg)
        out = [m.train_batch([x], [y], update=False),
               m.train_batch([x], [y]), m.eval_batch([x], [y]),
               m.predict_batch([x])[0]]
        return out
    r, p = _both(run)
    for a, b in zip(r, p):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)


def test_progress_text_matches_the_reference(capsys, clock):
    texts = []
    for pkg in (J, TP):
        model = _model(pkg)
        for verbose in (1, 2):
            model.fit(_data(pkg, 32, 0), _data(pkg, 16, 1), batch_size=8,
                      epochs=2, log_freq=2, verbose=verbose)
        model.evaluate(_data(pkg, 16, 2), batch_size=8, verbose=2)
        pkg.summary(model.network)
        texts.append(capsys.readouterr().out)
    assert "Epoch 2/2" in texts[1] and "Eval samples" in texts[1]
    assert texts[1] == texts[0]


def test_callbacks_match_the_reference(tmp_path):
    def run(pkg):
        events = []

        class Rec(pkg.callbacks.Callback):
            def on_epoch_begin(self, epoch, logs=None):
                events.append(("begin", epoch))

            def on_eval_end(self, logs=None):
                events.append(("eval", round(logs["loss"], 5)))

        sched = pkg.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                           gamma=0.5)
        model = _model(pkg, sched=sched)
        log = tmp_path / pkg.__name__
        es = pkg.callbacks.EarlyStopping(monitor="acc_top1", mode="max",
                                         patience=1, verbose=0,
                                         baseline=1.1)
        rlr = pkg.callbacks.ReduceLROnPlateau(patience=1, verbose=0)
        model.fit(_data(pkg, 32, 0), _data(pkg, 16, 1), batch_size=16,
                  epochs=4, callbacks=[Rec(), es, rlr,
                                       pkg.callbacks.VisualDL(str(log))],
                  save_dir=str(log / "ck"), verbose=0)
        files = sorted(os.listdir(log / "ck"))
        return (events, model.stop_training, model._optimizer.get_lr(),
                (log / "train.log").read_text(),
                (log / "eval.log").read_text(), files)
    r, p = _both(run)
    assert p[0] == r[0] and p[1] == r[1] and p[5] == r[5]
    np.testing.assert_allclose(p[2], r[2])
    for rt, pt in ((r[3], p[3]), (r[4], p[4])):
        rl = [ln.split("\t") for ln in rt.splitlines()]
        pl = [ln.split("\t") for ln in pt.splitlines()]
        assert [x[:2] for x in pl] == [x[:2] for x in rl]
        np.testing.assert_allclose([float(x[2]) for x in pl],
                                   [float(x[2]) for x in rl], **TOL)


def test_summary_lists_the_references_parameters(capsys):
    r, p = _both(lambda pkg: _model(pkg).summary())
    assert p == r
    nn = TP.nn
    assert TP.summary(nn.Sequential(nn.Linear(2, 3), nn.LayerNorm(3))) == \
        {"total_params": 15, "trainable_params": 15}


def test_a_jax_written_save_loads_into_the_port(tmp_path):
    ref = _model(J)
    ref.fit(_data(J, 32, 0), batch_size=16, epochs=1, verbose=0)
    path = str(tmp_path / "m")
    ref.save(path)
    port = _model(TP)
    port.load(path)
    for (n, a), (m, b) in zip(ref.network.named_parameters(),
                              port.network.named_parameters()):
        assert n == m
        np.testing.assert_array_equal(_np(b), _np(a))
    # the optimizer's moments came along: one more step agrees
    x = np.random.RandomState(5).randn(8, 2).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.int64)
    np.testing.assert_allclose(port.train_batch([x], [y]),
                               ref.train_batch([x], [y]), **TOL)
    for (_, a), (_, b) in zip(ref.network.named_parameters(),
                              port.network.named_parameters()):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)


def test_port_save_load_round_trip(tmp_path):
    model = _model(TP)
    model.fit(_data(TP, 32, 0), batch_size=16, epochs=1, verbose=0)
    path = str(tmp_path / "ckpt" / "m")
    model.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    model2 = _model(TP)
    model2.load(path)
    for (n, p), (_, q) in zip(model.network.named_parameters(),
                              model2.network.named_parameters()):
        assert torch.equal(p, q), n


def test_jit_compile_raises_not_ported():
    """``prepare(jit_compile=True)`` raised until ``jit`` was ported; it
    now trains through ``jit.TrainStep`` (tests/test_torch_jit.py holds
    it to the reference)."""
    net = TP.nn.Sequential(TP.nn.Linear(2, 2))
    model = TP.Model(net)
    opt = TP.optimizer.Adam(parameters=net.parameters())
    model.prepare(opt, TP.nn.CrossEntropyLoss(), jit_compile=True)
    assert model._train_step is not None
    losses = model.train_batch([np.ones((4, 2), np.float32)],
                               [np.zeros((4, 1), np.int64)])
    assert len(losses) == 1 and np.isfinite(losses[0])


#: the reference's scenario that reads ``Parameter._value`` (a layer's
#: parameter is a torch leaf here): its port counterpart is above
HAPI_SKIP = {"test_save_load"}


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_hapi.py", HAPI_SKIP))
def test_hapi_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_hapi.py", scenario, request)
