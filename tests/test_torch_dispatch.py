"""The port's dispatcher (``core.dispatch.apply``) and what rides on it,
against the JAX package's: ``amp.auto_cast`` at O1 and O2 (the dtypes
each op receives after the cast hook), the nan/inf checker's modes, the
dispatch telemetry's counts and the chain profiler's transitions for the
same op sequence, the flags, the offload round trips, and the scenarios
of ``tests/test_amp_debugging.py`` and ``tests/test_offload.py``. The
port runs on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as JP
import paddle_tpu_torch as TP
from paddle_tpu.amp import debugging as JD  # (installs the reference's hook)
from paddle_tpu.core import dispatch as JDisp
from paddle_tpu_torch import amp as TA
from paddle_tpu_torch.amp import debugging as TD
from paddle_tpu_torch.core import dispatch as TDisp
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _spy(disp, monkeypatch):
    """Record, per op name, the dtypes of the Tensor args after the cast
    hook."""
    seen = {}
    hook = disp.amp_cast_hook

    def spy(op_name, args):
        args = hook(op_name, args) if hook is not None else args
        seen.setdefault(op_name, []).append(tuple(
            str(a.dtype).rpartition(".")[2] for a in args
            if hasattr(a, "_value")))
        return args
    monkeypatch.setattr(disp, "amp_cast_hook", spy)
    return seen


def _amp_program(p, F, level, dtype_in="float32"):
    rng = np.random.RandomState(0)
    x = p.to_tensor(rng.randn(4, 8).astype(np.float32)).astype(dtype_in)
    w = p.to_tensor(rng.randn(8, 8).astype(np.float32)).astype(dtype_in)
    g = p.to_tensor(np.ones(8, np.float32)).astype(dtype_in)
    with p.amp.auto_cast(level=level, dtype="bfloat16",
                         custom_white_list={"multiply"} if level == "O1"
                         else None):
        y = p.matmul(x, w)
        z = F.rms_norm(y, g, 1e-6)
        e = p.exp(z)
        m = p.multiply(e, e)
        s = p.sum(m)
        ln = F.linear(x, w)
        ce = F.cross_entropy(ln, p.to_tensor(np.array([0, 1, 2, 3])))
    return y, z, e, m, s, ce


@pytest.mark.parametrize("level,dtype_in", [("O1", "float32"),
                                            ("O2", "bfloat16")])
def test_auto_cast_casts_each_op_as_the_reference(level, dtype_in,
                                                  monkeypatch):
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    got = {}
    outs = {}
    for name, p, F, disp in (("ref", JP, JF, JDisp), ("port", TP, TF, TDisp)):
        seen = _spy(disp, monkeypatch)
        outs[name] = [str(t.dtype).rpartition(".")[2]
                      for t in _amp_program(p, F, level, dtype_in)]
        got[name] = {op: v for op, v in seen.items()
                     if op in ("matmul", "rms_norm", "exp", "multiply", "sum",
                               "linear", "cross_entropy")}
    assert got["port"] == got["ref"]
    assert outs["port"] == outs["ref"]
    if level == "O1":
        assert got["port"]["matmul"] == [("bfloat16", "bfloat16")]
        assert got["port"]["multiply"] == [("bfloat16", "bfloat16")]
        assert got["port"]["rms_norm"] == [("bfloat16", "float32")]
    else:
        assert got["port"]["rms_norm"] == [("float32", "float32")]
        assert got["port"]["exp"] == [("float32",)]


def test_auto_cast_disabled_and_restored():
    x = TP.ones([2, 2])
    with TA.auto_cast(enable=False):
        assert TP.matmul(x, x).dtype == torch.float32
    with TA.auto_cast(level="O1", dtype="float16"):
        assert TP.matmul(x, x).dtype == torch.float16
        with TA.auto_cast(enable=False):
            assert TP.matmul(x, x).dtype == torch.float32
    assert not TA.amp_state()["enabled"]
    assert TP.matmul(x, x).dtype == torch.float32


def test_auto_cast_backward_casts_the_gradient_back():
    w = TP.Parameter(np.ones((3, 3), np.float32))
    x = TP.ones([2, 3])
    with TA.auto_cast(level="O1"):
        y = TP.matmul(x, w)
    assert y.dtype == torch.bfloat16
    y.astype("float32").sum().backward()
    assert w.grad.dtype == torch.float32
    np.testing.assert_allclose(w.grad.numpy(), np.full((3, 3), 2.0))


# ---------------------------------------------------------------------------
# the nan/inf checker (tests/test_amp_debugging.py's scenarios, both ways)
# ---------------------------------------------------------------------------

@pytest.fixture(params=["ref", "port"])
def stack(request):
    return (JP, JD) if request.param == "ref" else (TP, TD)


def test_check_numerics_eager(stack):
    p, D = stack
    ok = p.to_tensor(np.ones(4, np.float32))
    assert D.check_numerics(ok) == (0, 0)
    bad = p.to_tensor(np.array([1.0, np.nan, np.inf], np.float32))
    with pytest.raises(FloatingPointError, match="1 nan, 1 inf"):
        D.check_numerics(bad, op_type="test", var_name="x")
    n_nan, n_inf = D.check_numerics(bad, debug_mode=D.DebugMode.CHECK_NAN_INF)
    assert (n_nan, n_inf) == (1, 1)
    assert D.check_numerics(p.to_tensor([1, 2])) == (0, 0)


def test_dispatch_flag_scan(stack):
    p, D = stack
    D.enable_tensor_checker(D.TensorCheckerConfig(enable=True))
    try:
        x = p.to_tensor(np.zeros(3, np.float32))
        x.stop_gradient = False
        with pytest.raises(FloatingPointError, match="'divide'"):
            p.to_tensor(np.zeros(3, np.float32)) / x
    finally:
        D.disable_tensor_checker()


def test_dispatch_flag_scan_no_grad_path(stack):
    p, D = stack
    D.enable_tensor_checker(D.TensorCheckerConfig(enable=True))
    try:
        a = p.to_tensor(np.zeros(3, np.float32))
        with pytest.raises(FloatingPointError):
            a / a
    finally:
        D.disable_tensor_checker()
    assert not p.get_flags("check_nan_inf")["check_nan_inf"]


def test_report_only_mode_does_not_abort(stack):
    p, D = stack
    D.enable_tensor_checker(D.TensorCheckerConfig(
        enable=True, debug_mode=D.DebugMode.CHECK_NAN_INF))
    try:
        a = p.to_tensor(np.zeros(3, np.float32))
        out = a / a
        assert np.isnan(np.asarray(out.numpy())).all()
    finally:
        D.disable_tensor_checker()


def test_skipped_and_checked_op_lists(stack):
    p, D = stack
    a = p.to_tensor(np.zeros(3, np.float32))
    D.enable_tensor_checker(D.TensorCheckerConfig(
        enable=True, skipped_op_list=["divide"]))
    try:
        a / a
    finally:
        D.disable_tensor_checker()
    D.enable_tensor_checker(D.TensorCheckerConfig(
        enable=True, checked_op_list=["log"]))
    try:
        a / a                        # not checked
        with pytest.raises(FloatingPointError, match="'log'"):
            p.log(a - 1.0)
    finally:
        D.disable_tensor_checker()


def test_checkify_counterpart_names_the_aten_op():
    wrapped = TD.checkify_wrap(lambda x: torch.log(x).sum())
    assert float(wrapped(torch.ones(3))) == 0.0
    with pytest.raises(FloatingPointError, match="aten.log"):
        wrapped(torch.tensor([-1.0, 1.0]))
    inv = TD.checkify_wrap(lambda x: (1.0 / x).sum(), jit=False)
    with pytest.raises(FloatingPointError, match="aten"):
        inv(torch.tensor([0.0, 1.0]))
    # through the Tensor surface too
    wrapped_t = TD.checkify_wrap(lambda t: TP.sqrt(t))
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        wrapped_t(TP.to_tensor([-4.0]))


def test_compare_accuracy_raises_as_the_reference():
    for D in (JD, TD):
        with pytest.raises(NotImplementedError):
            D.compare_accuracy("a", "b", "c")


# ---------------------------------------------------------------------------
# telemetry and chain taps: the same counters as the reference
# ---------------------------------------------------------------------------

def _eager_program(p):
    x = p.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    for _ in range(3):
        y = p.exp(x * 0.1)
        z = p.matmul(y, y, transpose_y=True)
        x = (z.sum(axis=1, keepdim=True) + x)[:, :3]
    return x


def test_telemetry_counts_and_chains_equal_the_reference():
    from paddle_tpu.observability.profiling import chain_profiler as jcp
    from paddle_tpu.observability.runtime import telemetry as jt
    from paddle_tpu_torch.observability.profiling import chain_profiler as tcp
    from paddle_tpu_torch.observability.runtime import telemetry as tt
    res = {}
    for name, p, tele, cp in (("ref", JP, jt, jcp), ("port", TP, tt, tcp)):
        was = tele.enabled
        tele.enable()
        tele.reset()
        cp.reset()
        cp.arm()
        try:
            out = _eager_program(p)
        finally:
            cp.disarm()
            (tele.enable if was else tele.disable)()
        res[name] = (dict(tele.op_counts), cp.chains(top_n=20),
                     np.asarray(out.numpy()))
    assert res["port"][0] == res["ref"][0]
    assert [(c["ops"], c["count"]) for c in res["port"][1]] == \
        [(c["ops"], c["count"]) for c in res["ref"][1]]
    np.testing.assert_allclose(res["port"][2], res["ref"][2], rtol=1e-5)


def test_disarmed_dispatch_counts_nothing():
    from paddle_tpu_torch.observability.runtime import dispatch_armed, telemetry
    was = telemetry.enabled
    telemetry.disable()
    try:
        assert not dispatch_armed[0]
        telemetry.reset()
        TP.ones([2]) + 1
        assert telemetry.op_counts == {}
    finally:
        (telemetry.enable if was else telemetry.disable)()


def test_dispatch_sites_resolve_the_port_ops():
    from paddle_tpu_torch.observability.profiling import dispatch_sites
    sites = dispatch_sites()
    assert sites["rms_norm"] == "paddle_tpu_torch.ops.rms_norm.rms_norm"
    assert sites["flash_attention"] == \
        "paddle_tpu_torch.nn.functional.scaled_dot_product_attention"
    assert sites["clip"] == "paddle_tpu_torch.core.math_ops.clip"
    assert sites["cbe.plan_step"].startswith(
        "paddle_tpu_torch.inference.decoding.ContinuousBatchingEngine.")
    assert "add" not in sites            # a generated family stays opaque
    doc = __import__("paddle_tpu_torch.observability.profiling",
                     fromlist=["x"]).chain_profiler.profile(
        op_counts={"rms_norm": 2}, resolve=False)
    assert doc["kind"] == "paddle_tpu.hot_chains" and doc["version"] == 1


def test_engine_chain_taps():
    from paddle_tpu_torch.inference.decoding import (ContinuousBatchingEngine,
                                                     GenerationConfig)
    from paddle_tpu_torch.inference.sampling import SamplerConfig
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.observability.profiling import chain_profiler as cp
    cfg = TL.llama_tiny(num_hidden_layers=1)
    params = TL.init_params(cfg, 0, device="cpu")
    eng = ContinuousBatchingEngine(cfg, GenerationConfig(max_new_tokens=3),
                                   num_slots=2, page_size=4, max_seq_len=32,
                                   chunk=2, device="cpu")
    cp.reset()
    cp.arm()
    try:
        eng.submit(np.arange(1, 6, dtype=np.int32),
                   sampler=SamplerConfig(temperature=0.7, seed=1))
        while eng.step(params):
            pass
    finally:
        cp.disarm()
    pairs = cp._pairs
    assert pairs[("cbe.plan_step", "cbe.unified_step")] >= 1
    assert pairs[("cbe.unified_step", "cbe.sample_epilogue")] >= 1
    assert cp.mean_us("cbe.unified_step") > 0


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def test_flags_match_the_reference_corpus():
    ref, port = JP.get_flags(), TP.get_flags()
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k in ("use_pallas_kernels", "use_pallas_rms_norm",
                 "use_pallas_layer_norm"):
            assert port[k] is True
        else:
            assert port[k] == v, k
    assert TP.get_flags(["FLAGS_log_level"]) == {"FLAGS_log_level": 0}
    TP.set_flags({"FLAGS_log_level": "3", "deterministic": 1})
    try:
        assert TP.get_flags("log_level") == {"log_level": 3}
        assert TP.flags.flag_value("deterministic") is True
    finally:
        TP.set_flags({"log_level": 0, "deterministic": False})
    with pytest.raises(ValueError):
        TP.get_flags("no_such_flag")


@pytest.mark.parametrize("flag", ["use_pallas_kernels", "use_pallas_rms_norm",
                                  "use_pallas_layer_norm"])
def test_routing_flags_cannot_be_set(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        TP.set_flags({f"FLAGS_{flag}": False})
    assert TP.get_flags(flag)[flag] is True


def test_flags_read_the_environment():
    code = ("import paddle_tpu_torch.flags as f; "
            "print(f.flag_value('log_level'), f.flag_value('use_pallas_kernels'))")
    env = dict(os.environ, FLAGS_log_level="2", FLAGS_use_pallas_kernels="0")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.stdout.split() == ["2", "True"], out.stderr


def test_benchmark_flag_waits_and_keeps_results():
    TP.set_flags({"benchmark": True})
    try:
        assert float((TP.ones([3]) * 2).sum()) == 6.0
    finally:
        TP.set_flags({"benchmark": False})


# ---------------------------------------------------------------------------
# offload (tests/test_offload.py's scenarios)
# ---------------------------------------------------------------------------

def test_offload_reload_roundtrip():
    from paddle_tpu_torch.core import offload
    t = TP.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    ref = t.numpy().copy()
    before = t._value
    offload.offload_to_host(t)
    assert t._value is not before
    out = offload.reload_to_device(t)
    assert out is t and isinstance(out._value, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_offload_plain_tensor():
    from paddle_tpu_torch.core import offload
    host = offload.offload_to_host(torch.ones(4))
    back = offload.reload_to_device(host, "cpu")
    np.testing.assert_array_equal(back.numpy(), np.ones(4))


def test_offload_checkpoint_policy_usable():
    from paddle_tpu_torch.core import offload
    w = torch.ones(4, 4, requires_grad=True)
    x = torch.ones(2, 4)
    with offload.offload_checkpoint_policy():
        loss = torch.tanh(x @ w).sum()
    (g,) = torch.autograd.grad(loss, w)
    (want,) = torch.autograd.grad(torch.tanh(x @ w).sum(), w)
    assert g.shape == (4, 4)
    torch.testing.assert_close(g, want)
