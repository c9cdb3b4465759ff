"""``paddle_tpu_torch.utils`` (``try_import``, ``deprecated``,
``run_check``, ``dlpack``, ``unique_name``), ``version``, ``hub`` and
``onnx`` against the reference's on the CPU: the same calls give the
same names, values, messages and errors. The stated differences:
``version.cuda()``/``cudnn()`` report torch's CUDA and cuDNN (the
reference has none and says ``"False"``), and ``onnx.export`` points
at ``paddle_tpu_torch.jit.save``."""

import math

import numpy as np
import pytest
import torch

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


def _np(t):
    v = t._value if hasattr(t, "_value") else t
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def test_every_long_tail_name_is_ported():
    for name in ("linalg", "fft", "signal", "sparse", "geometric",
                 "distribution", "audio", "text", "utils", "version", "hub",
                 "onnx"):
        assert getattr(TP, name).__name__ == f"paddle_tpu_torch.{name}"
    assert TP._LATER == {}
    assert TP.profiler.Profiler and TP.incubate.autograd.Jacobian


def test_dlpack_round_trips():
    x = TP.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    y = TP.utils.dlpack.from_dlpack(TP.utils.dlpack.to_dlpack(x))
    np.testing.assert_array_equal(_np(y), _np(x))
    assert _np(y).ctypes.data == _np(x).ctypes.data     # shared memory
    for src in (np.arange(4, dtype=np.float32),
                torch.arange(4, dtype=torch.float32)):
        want = _np(J.utils.dlpack.from_dlpack(src))
        np.testing.assert_array_equal(_np(TP.utils.dlpack.from_dlpack(src)),
                                      want)
    # the reference's carrier is taken too, and the port's by the reference
    r = J.utils.dlpack.to_dlpack(J.to_tensor(np.ones(3, np.float32)))
    np.testing.assert_array_equal(_np(TP.utils.dlpack.from_dlpack(r)),
                                  np.ones(3))
    np.testing.assert_array_equal(
        _np(J.utils.dlpack.from_dlpack(TP.utils.dlpack.to_dlpack(x))),
        _np(x))
    with pytest.raises(TypeError):
        TP.utils.dlpack.from_dlpack(object())


def test_unique_name_counts_as_the_reference():
    names = []
    for pkg in (J, TP):
        un = pkg.utils.unique_name
        with un.guard():
            a = [un.generate("layer"), un.generate("layer"),
                 un.generate("fc")]
            with un.guard():
                a.append(un.generate("layer"))
            a.append(un.generate("layer"))
        names.append(a)
    assert names[1] == names[0] == ["layer_0", "layer_1", "fc_0", "layer_0",
                                    "layer_2"]
    old = TP.utils.unique_name.switch()
    assert TP.utils.unique_name.switch(old) is not old


def test_try_import_deprecated_and_run_check(capsys):
    assert TP.utils.try_import("math") is math
    for pkg in (J, TP):
        with pytest.raises(ImportError, match="not installed"):
            pkg.utils.try_import("definitely_not_a_module_xyz")
        with pytest.raises(ImportError, match="custom"):
            pkg.utils.try_import("definitely_not_a_module_xyz", "custom")

    msgs = []
    for pkg in (J, TP):
        @pkg.utils.deprecated(update_to="paddle.new_api", since="2.0",
                              reason="renamed")
        def old():
            return 42
        with pytest.warns(DeprecationWarning) as rec:
            assert old() == 42
        msgs.append(str(rec[0].message))
    assert msgs[1] == msgs[0]
    TP.utils.run_check()
    assert "installed successfully" in capsys.readouterr().out


def test_version():
    V, RV = TP.version, J.version
    for k in ("full_version", "major", "minor", "patch", "rc", "istaged",
              "commit", "with_pip", "xpu_version"):
        assert getattr(V, k) == getattr(RV, k), k
    assert V.full_version == TP.__version__
    assert V.xpu() == RV.xpu() == "False"
    want = str(torch.version.cuda) if torch.version.cuda else "False"
    assert V.cuda() == V.cuda_version == want
    assert V.cudnn() == V.cudnn_version
    if not torch.version.cuda:
        assert V.cudnn() == "False"


def test_version_show(capsys):
    TP.version.show()
    got = capsys.readouterr().out
    J.version.show()
    want = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == \
        [ln.split(":")[0] for ln in want.splitlines()]


def _hubconf(tmp_path, pkg_name):
    (tmp_path / "hubconf.py").write_text(
        "def tiny(out_features=2):\n"
        "    'A tiny linear model.'\n"
        f"    import {pkg_name} as paddle\n"
        "    return paddle.nn.Linear(4, out_features)\n"
        "def _private():\n"
        "    pass\n")
    return str(tmp_path)


def test_hub_local_source(tmp_path):
    repo = _hubconf(tmp_path, "paddle_tpu_torch")
    assert TP.hub.list(repo) == J.hub.list(repo) == ["tiny"]
    assert TP.hub.help(repo, "tiny") == J.hub.help(repo, "tiny") == \
        "A tiny linear model."
    m = TP.hub.load(repo, "tiny", out_features=3)
    assert tuple(m(TP.to_tensor(np.ones((1, 4), np.float32))).shape) == (1, 3)
    for fn in (TP.hub.help, TP.hub.load):
        with pytest.raises(RuntimeError, match="entrypoint"):
            fn(repo, "missing")
    with pytest.raises(FileNotFoundError):
        TP.hub.list(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("source", ["github", "gitee"])
def test_hub_remote_sources_raise(source):
    for pkg in (J, TP):
        with pytest.raises(RuntimeError, match="network"):
            pkg.hub.list("user/repo", source=source)


def test_onnx_export_raises_the_references_error():
    for pkg, where in ((J, "jit.save"), (TP, "paddle_tpu_torch.jit.save")):
        with pytest.raises(ImportError, match="paddle2onnx") as e:
            pkg.onnx.export(None, "model")
        assert where in str(e.value)
