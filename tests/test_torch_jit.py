"""``paddle_tpu_torch.jit`` (``to_static``, ``TrainStep``, ``multi_step``,
the compile guard, bucketing) and ``Model.prepare(jit_compile=True)``
against ``paddle_tpu.jit`` on the CPU: the reference's own scenarios
(``tests/test_jit.py``) run through the port, and the same seeded
layers, batches and optimizers through both packages' compiled steps —
SGD, Adam and AdamW with a global-norm clip, a step scheduler and
dropout whose masks vary per call (the per-call key folds a counter
reset to 0, as the reference's traced key) — with losses and weights
within rtol 1e-5, atol 1e-6 after each step, and the guards' recompile
counts equal. fp32. On the CPU a compiled program runs its body each
call; the card's CUDA graphs are held to their graphs-off runs in
``tests/test_torch_gpu.py``."""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch import testing as T
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

import torch_scenarios

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import transformer_mt as M  # noqa: E402

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


#: the scenario that reads ``Parameter._value`` (a layer's parameter is a
#: torch leaf here): its counterpart is
#: ``test_multi_step_matches_sequential_steps_and_reference``
JIT_SKIP = {"TestMultiStep.test_matches_sequential_steps"}


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_jit.py", JIT_SKIP))
def test_jit_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_jit.py", scenario, request)


def _mlp(pkg, drop=0.0):
    nn = pkg.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 16)
            self.fc2 = nn.Linear(16, 3)
            self.d = nn.Dropout(drop)

        def forward(self, x):
            return self.fc2(self.d(pkg.nn.functional.relu(self.fc1(x))))
    return MLP()


def _pair(drop=0.0, seed=7):
    """The same MLP in both packages (weights carried from the JAX one)
    and the framework streams at the same counter."""
    J.seed(seed)
    jnet = _mlp(J, drop)
    TP.seed(seed)
    tnet = _mlp(TP, drop)
    for (n, jp), (m, tp) in zip(jnet.named_parameters(),
                                tnet.named_parameters()):
        assert n == m
        tp.set_value(np.asarray(jp._value))
    assert J.get_rng_state()[0] == TP.get_rng_state()[0]
    return jnet, tnet


def _opt(pkg, family, net):
    o = pkg.optimizer
    sched = o.lr.StepDecay(learning_rate=0.05, step_size=2, gamma=0.5)
    clip = o.ClipGradByGlobalNorm(0.5)
    if family == "SGD":
        return o.SGD(learning_rate=sched, parameters=net.parameters(),
                     grad_clip=clip), sched
    if family == "Adam":
        return o.Adam(learning_rate=sched, parameters=net.parameters(),
                      grad_clip=clip), sched
    return o.AdamW(learning_rate=sched, parameters=net.parameters(),
                   grad_clip=clip, weight_decay=0.01), sched


def _batches(n=3):
    rs = np.random.RandomState(1)
    return [(rs.randn(8, 4).astype(np.float32),
             rs.randint(0, 3, size=(8,)).astype(np.int64)) for _ in range(n)]


@pytest.mark.parametrize("family", ["SGD", "Adam", "AdamW"])
def test_train_step_matches_reference(family):
    """Three compiled steps with clip, scheduler and dropout 0.5: losses
    and weights follow the reference's TrainStep step by step."""
    jnet, tnet = _pair(drop=0.5)
    jopt, jsched = _opt(J, family, jnet)
    topt, tsched = _opt(TP, family, tnet)
    jstep = J.jit.TrainStep(
        jnet, lambda m, x, y: J.nn.functional.cross_entropy(m(x), y), jopt)
    tstep = TP.jit.TrainStep(
        tnet, lambda m, x, y: TP.nn.functional.cross_entropy(m(x), y), topt)
    seen = set()
    for x, y in _batches():
        lj = float(jstep(J.to_tensor(x), J.to_tensor(y)))
        lt = float(tstep(TP.to_tensor(x), TP.to_tensor(y)))
        np.testing.assert_allclose(lt, lj, **TOL)
        seen.add(lt)
        for (n, jp), (_, tp) in zip(jnet.named_parameters(),
                                    tnet.named_parameters()):
            np.testing.assert_allclose(_np(tp), np.asarray(jp._value),
                                       err_msg=n, **TOL)
        jsched.step()
        tsched.step()
    assert topt.step_count == jopt._step_count == 3
    assert all(p.grad is None for p in tnet.parameters())
    assert tstep.guard.recompile_count == jstep.guard.recompile_count == 0


def test_train_step_guard_counts_recompiles_as_reference():
    jnet, tnet = _pair()
    steps = []
    for pkg, net in ((J, jnet), (TP, tnet)):
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=net.parameters())
        steps.append(pkg.jit.TrainStep(
            net, lambda m, x: (m(x) ** 2).mean(), opt))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for rows in (8, 8, 4, 8, 5, 4):
            x = np.ones((rows, 4), np.float32)
            lj = float(steps[0](J.to_tensor(x)))
            lt = float(steps[1](TP.to_tensor(x)))
            np.testing.assert_allclose(lt, lj, **TOL)
    assert steps[1].guard.recompile_count == steps[0].guard.recompile_count \
        == 2


def test_multi_step_matches_sequential_steps_and_reference():
    """``multi_step(3)``: the same weights and last loss as three
    sequential steps (the reference's contract) and as the reference's
    ``multi_step``."""
    rs = np.random.RandomState(0)
    xs = rs.randn(3, 4, 4).astype(np.float32)
    ys = rs.randn(3, 4, 3).astype(np.float32)

    def build(pkg, net):
        opt = pkg.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=net.parameters())
        return pkg.jit.TrainStep(
            net, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt)

    jnet, tnet = _pair()
    _, tnet2 = _pair()
    jrun = build(J, jnet).multi_step(3)
    trun = build(TP, tnet).multi_step(3)
    assert build(TP, tnet).multi_step(3) is not trun
    tseq = build(TP, tnet2)
    lj = float(jrun(J.to_tensor(xs), J.to_tensor(ys)))
    lt = float(trun(TP.to_tensor(xs), TP.to_tensor(ys)))
    for i in range(3):
        ls = float(tseq(TP.to_tensor(xs[i]), TP.to_tensor(ys[i])))
    np.testing.assert_allclose(lt, lj, **TOL)
    np.testing.assert_allclose(lt, ls, rtol=1e-5)
    for (n, jp), (_, tp), (_, sp) in zip(jnet.named_parameters(),
                                         tnet.named_parameters(),
                                         tnet2.named_parameters()):
        np.testing.assert_allclose(_np(tp), np.asarray(jp._value),
                                   err_msg=n, **TOL)
        np.testing.assert_allclose(_np(tp), _np(sp), rtol=2e-5, atol=2e-6,
                                   err_msg=n)
    with pytest.raises(ValueError, match="leading 3 axis"):
        trun(TP.to_tensor(xs[0]), TP.to_tensor(ys[0]))


def test_to_static_matches_reference_and_guards():
    jnet, tnet = _pair(drop=0.5)
    J.jit.to_static(jnet)
    TP.jit.to_static(tnet)
    jnet.eval()
    tnet.eval()
    for rows in (3, 3, 5):
        x = np.random.RandomState(rows).randn(rows, 4).astype(np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(jnet(J.to_tensor(x))._value)
            got = tnet(TP.to_tensor(x))
        np.testing.assert_allclose(_np(got), want, **TOL)
        assert got.stop_gradient
    assert tnet.forward.recompile_count == jnet.forward.recompile_count == 1


@pytest.mark.parametrize("values", [(2.0, 3.0, 3), (True, False, 4)])
def test_to_static_python_numbers_are_program_inputs_as_reference(values):
    """A Python number reaches the compiled body as a 0-d Tensor (the
    reference's ``jax.jit`` traces it): a new value of the same type
    reuses the program and still computes with the new value, a new
    type is a counted recompile, and a ``range`` over a traced int
    lowers. The guards' recompile counts equal the reference's."""
    def f(x, s, n):
        y = x * s
        for _ in range(n):
            y = y + 1.0
        return y

    jf, tf = J.jit.to_static(f), TP.jit.to_static(f)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    seen = []
    for s in values:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(jf(J.to_tensor(x), s, 2)._value)
            got = tf(TP.to_tensor(x), s, 2)
        np.testing.assert_allclose(_np(got), want, **TOL)
        np.testing.assert_allclose(_np(got), x * s + 2.0, **TOL)
        seen.append(_np(got))
    assert not np.array_equal(seen[0], seen[1])
    assert tf.recompile_count == jf.recompile_count == 1
    assert tf.programs.entries == {} and not tf._fallback
    with pytest.raises(TypeError, match="hashable constant"):
        tf(TP.to_tensor(x), [], {"k": {1}})


def test_bucketing_matches_reference():
    for n, buckets in ((87, (64, 128, 256)), (100, None), (64, (64,))):
        assert TP.jit.next_bucket(n, buckets) == J.jit.next_bucket(n, buckets)
    x = np.random.RandomState(0).randn(87, 3).astype(np.float32)
    for axis in (0, 1):
        tp, tn = TP.jit.pad_to_bucket(TP.to_tensor(x), axis=axis,
                                      buckets=(64, 128), pad_value=-1)
        jp, jn = J.jit.pad_to_bucket(J.to_tensor(x), axis=axis,
                                     buckets=(64, 128), pad_value=-1)
        assert tn == jn
        np.testing.assert_array_equal(_np(tp), np.asarray(jp._value))
    tb = TP.jit.ShapeBucketer({0: (32, 64), 1: None}, multiple=8)
    jb = J.jit.ShapeBucketer({0: (32, 64), 1: None}, multiple=8)
    for rows, cols in ((5, 3), (40, 9), (30, 16), (64, 1)):
        a = np.ones((rows, cols), np.int32)
        (tpad, tv), (jpad, jv) = tb(a), jb(a)
        assert tv == jv and tuple(tpad.shape) == tuple(np.shape(jpad))
    assert tb.num_signatures == jb.num_signatures


def _fit(package, jit_compile):
    S = M.surface(package)
    cfg = dict(M.TINY)
    S.paddle.seed(3)
    net = M.build_model(S, cfg)
    pairs = M.sentence_pairs(12, cfg["vocab"], 8, 8, seed=0)
    loader = M.make_loader(S, pairs, 4 * 9, cfg["max_length"])
    model = M.prepare(S, net, cfg, jit_compile=jit_compile)
    hist = []

    class Rec(S.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            hist.append(logs["loss"])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(loader, epochs=1, verbose=0, callbacks=[Rec()])
    return hist, {k: _np(v) for k, v in net.state_dict().items()}


def test_model_fit_jit_compile_on_tiny_transformer_matches_reference():
    """``Model.prepare(jit_compile=True)`` over ``scripts/transformer_mt.py``
    (dropout 0.1, Noam schedule, label smoothing): three compiled steps
    through both packages agree within ``testing.MT_FIT``."""
    rl, rw = _fit("paddle_tpu", True)
    pl, pw = _fit("paddle_tpu_torch", True)
    assert len(pl) == len(rl) == 3
    np.testing.assert_allclose(pl, rl, **T.MT_FIT)
    for k in rw:
        np.testing.assert_allclose(pw[k], rw[k], err_msg=k, **T.MT_FIT)


def test_jit_compile_rules_match_reference():
    """Metrics warn, ``update=False`` raises, a changed label count
    raises — the reference's rules."""
    for pkg in (J, TP):
        pkg.seed(0)
        net = pkg.nn.Sequential(pkg.nn.Linear(2, 4), pkg.nn.Linear(4, 2))
        model = pkg.Model(net)
        opt = pkg.optimizer.Adam(parameters=net.parameters())
        with pytest.warns(UserWarning, match="metrics are not computed"):
            model.prepare(opt, pkg.nn.CrossEntropyLoss(),
                          pkg.metric.Accuracy(), jit_compile=True)
        x = np.ones((4, 2), np.float32)
        y = np.zeros((4, 1), np.int64)
        with pytest.raises(ValueError, match="update=False"):
            model.train_batch([x], [y], update=False)
        model.train_batch([x], [y])
        with pytest.raises(ValueError, match="label count changed"):
            model.train_batch([x], [y, y])


def test_top_level_jit_and_static_are_ported():
    assert TP.jit.TrainStep is not None and TP.jit.to_static is not None
    assert TP.static.InputSpec is not None
    assert TP.jit.save is TP.jit.save_load.save
