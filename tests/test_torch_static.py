"""``paddle_tpu_torch.static`` against ``paddle_tpu.static`` on the CPU:
the reference's executor scenarios (``tests/test_static_engine.py``; its
module imports the auto-parallel ``Engine``, which waits on the port's
distributed package, so they are written out here), and the same seeded
layers and inputs through both
packages' ``save_inference_model`` → ``load_inference_model`` →
``Executor.run`` (outputs within rtol 1e-5, atol 1e-6), the feed/fetch
names and errors, the legacy script shims, and the ``static.nn``
builders and control-flow ops (``cond``, ``while_loop``, ``case``,
``switch_case``) eagerly and inside ``to_static``. fp32."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

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


def _ref_net(pkg):
    pkg.seed(11)
    return pkg.nn.Sequential(pkg.nn.Linear(6, 24), pkg.nn.Tanh(),
                             pkg.nn.Linear(24, 2))


def test_executor_runs_loaded_program(tmp_path):
    """The reference's scenario: a saved Sequential runs through
    ``Executor.run`` with the layer's own output."""
    net = _ref_net(TP)
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    ref = _np(net(TP.to_tensor(x)))
    prefix = str(tmp_path / "prog")
    TP.static.save_inference_model(
        prefix, [TP.static.InputSpec([3, 6], "float32")], None, layer=net)
    exe = TP.static.Executor()
    prog, feed_names, _ = TP.static.load_inference_model(prefix, exe)
    outs = exe.run(prog, feed={feed_names[0]: x}, fetch_list=[0])
    np.testing.assert_allclose(outs[0], ref, rtol=1e-5)


def test_executor_missing_feed_raises(tmp_path):
    net = _ref_net(TP)
    prefix = str(tmp_path / "prog2")
    TP.static.save_inference_model(
        prefix, [TP.static.InputSpec([1, 6], "float32")], None, layer=net)
    exe = TP.static.Executor()
    prog, _, _ = TP.static.load_inference_model(prefix, exe)
    with pytest.raises(ValueError):
        exe.run(prog, feed={}, fetch_list=[0])


def _net(pkg):
    pkg.seed(11)
    nn = pkg.nn
    return nn.Sequential(nn.Linear(6, 24), nn.Tanh(), nn.LayerNorm(24),
                         nn.Linear(24, 2))


def test_saved_program_runs_like_reference(tmp_path):
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    outs = []
    for pkg in (J, TP):
        net = _net(pkg)
        prefix = str(tmp_path / pkg.__name__ / "prog")
        pkg.static.save_inference_model(
            prefix, [pkg.static.InputSpec([None, 6], "float32")], None,
            layer=net)
        exe = pkg.static.Executor()
        prog, feeds, fetches = pkg.static.load_inference_model(prefix, exe)
        assert feeds == ["x0"] and fetches == ["out0"]
        # None became 1 at save time, as in the reference
        assert list(prog._translated.input_spec[0].shape) == [1, 6]
        got = exe.run(prog, feed={"x0": x[:1]}, fetch_list=["out0"])
        outs.append(got[0])
        with pytest.raises(ValueError, match="unknown fetch"):
            exe.run(prog, feed={"x0": x[:1]}, fetch_list=["nope"])
        with pytest.raises(ValueError, match="missing feed"):
            exe.run(prog, feed={}, fetch_list=[0])
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_graph_building_and_legacy_shims_match_reference():
    for pkg in (J, TP):
        with pytest.raises(NotImplementedError):
            pkg.static.default_main_program()
        spec = pkg.static.data("x", [None, 3], "float32")
        assert tuple(spec.shape) == (None, 3) and spec.name == "x"
        with pkg.static.program_guard(), pkg.static.name_scope("a"), \
                pkg.static.scope_guard(), pkg.static.device_guard():
            pass
        assert pkg.static.global_scope().find_var("w") is None
        assert len(pkg.static.cpu_places(2)) == 2
        with pytest.raises(ValueError, match="loaded Program"):
            pkg.static.Executor().run(pkg.static.Program())
    assert TP.static.cuda_places() == [] or torch.cuda.is_available()


def _builders(pkg, x):
    S = pkg.static.nn
    pkg.static.nn.static_param_store().clear()
    pkg.seed(5)
    h = S.fc(x, 8, activation="relu", name="fc1")
    h2 = S.fc(x, 8, activation="relu", name="fc1")      # reused params
    ln = S.layer_norm(h, begin_norm_axis=1, name="ln")
    emb = S.embedding(pkg.to_tensor(np.array([[1, 2], [3, 0]], np.int32)),
                      size=(5, 4), name="emb")
    return h, h2, ln, emb


def test_static_nn_builders_match_reference():
    x = np.random.RandomState(2).randn(4, 3, 2).astype(np.float32)
    j = _builders(J, J.to_tensor(x))
    t = _builders(TP, TP.to_tensor(x))
    for a, b in zip(j, t):
        np.testing.assert_allclose(_np(b), np.asarray(a._value), **TOL)
    np.testing.assert_array_equal(_np(t[0]), _np(t[1]))


def _control(pkg, x):
    S = pkg.static.nn
    c = S.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)
    i, s = S.while_loop(lambda i, s: i < 4, lambda i, s: (i + 1, s + x),
                        [pkg.to_tensor(np.int32(0)), x * 0.0])
    k = S.case([(x.sum() > 100.0, lambda: x * 0.0),
                (x.sum() > 0, lambda: x + 5.0)], default=lambda: -x)
    w = S.switch_case(pkg.to_tensor(np.int32(1)),
                      {0: lambda: x * 0.0, 1: lambda: x * 3.0},
                      default=lambda: x)
    return c, s, k, w


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "to_static"])
def test_static_nn_control_flow_matches_reference(compiled):
    x = np.array([0.5, -0.25, 1.0], np.float32)
    outs = []
    for pkg in (J, TP):
        fn = (lambda v, p=pkg: _control(p, v))
        if compiled:
            fn = pkg.jit.to_static(fn)
        outs.append([_np(o) for o in fn(pkg.to_tensor(x))])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)
