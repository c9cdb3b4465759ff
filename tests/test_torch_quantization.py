"""Quantization: ``paddle_tpu_torch.quantization`` (weight-only int8 and
int4, QAT and PTQ), ``nn.quant``, the int8 fused stack
(``fused_multi_transformer_array(int8=True)``,
``FusedMultiTransformerInt8``) and Llama's int8 leaves through the
serving engines, against the JAX package on the CPU on the same numpy
inputs and weights.

Bounds: quantized bytes and the A8W8 products' int32 sums are exact, so
they are compared bit for bit; fp32 outputs that go through matmuls
differ by the two packages' summation orders (``OUT``, the fused-stack
tests' bound); greedy tokens must be identical. Each case of the JAX
package's ``test_quantization.py`` has a case here (``REF_CASES``) that
runs it in both packages and holds the port to the reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as _place
from paddle_tpu import quantization as JQ
from paddle_tpu.incubate.nn import FusedMultiTransformer as JFMT
from paddle_tpu.incubate.nn import FusedMultiTransformerInt8 as JFMT8
from paddle_tpu.inference import decoding as JD
from paddle_tpu.models import llama as JL
from paddle_tpu.ops import fused_transformer_block as JB
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer as TFMT
from paddle_tpu_torch.incubate.nn import FusedMultiTransformerInt8 as TFMT8
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability.memory import pytree_nbytes
from paddle_tpu_torch.observability.runtime import recompiles
from paddle_tpu_torch.ops import fused_transformer_block as TB
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def _cpu_place():
    """The CPU is this file's place; the next file's is left as found."""
    prev = _place._current_place[0]
    tp.set_device("cpu")
    yield
    _place._current_place[0] = prev

OUT = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _np(a):
    """A Tensor, torch tensor or JAX array as numpy."""
    v = getattr(a, "_value", a)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tt(a):
    return tp.to_tensor(np.asarray(a))


def _jt(a):
    return jp.to_tensor(np.asarray(a))


def _tq(params):
    """A JAX stacked dict (int8 leaves included) carried to numpy."""
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# the JAX package's test_quantization.py cases, held to the reference
# ---------------------------------------------------------------------------

def case_int8_roundtrip_error():
    w = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    jq, js = JQ.weight_quantize(w)
    q, s = TQ.weight_quantize(w, device="cpu")
    assert q.dtype == torch.int8 and tuple(s.shape) == (32,)
    np.testing.assert_array_equal(_np(q), _np(jq))
    np.testing.assert_array_equal(_np(s), _np(js))
    wd = _np(TQ.weight_dequantize(q, s))
    assert wd.dtype == np.float32
    np.testing.assert_array_equal(wd, _np(JQ.weight_dequantize(jq, js)))
    assert np.abs(wd - w).max() / np.abs(w).max() < 0.01


def case_int4_roundtrip_error():
    w = np.random.RandomState(1).randn(64, 16).astype(np.float32)
    jq, js = JQ.weight_quantize(w, "weight_only_int4")
    q, s = TQ.weight_quantize(w, "weight_only_int4", device="cpu")
    assert tuple(q.shape) == (32, 16)          # packed two a byte
    np.testing.assert_array_equal(_np(q), _np(jq))   # the packed bytes
    wd = _np(TQ.weight_dequantize(q, s, "weight_only_int4"))
    np.testing.assert_array_equal(
        wd, _np(JQ.weight_dequantize(jq, js, "weight_only_int4")))
    assert np.abs(wd - w).max() / np.abs(w).max() < 0.12


def case_weight_only_linear_matches_dense():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 64).astype(np.float32)
    w = rng.randn(64, 32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    jq, js = JQ.weight_quantize(w)
    want = JQ.weight_only_linear(_jt(x), _jt(jq), _jt(js), _jt(b))
    q, s = TQ.weight_quantize(w, device="cpu")
    got = TQ.weight_only_linear(_tt(x), _tt(q), _tt(s), _tt(b))
    np.testing.assert_allclose(_np(got), _np(want), **OUT)
    ref = x @ w + b
    assert np.abs(_np(got) - ref).max() / np.abs(ref).max() < 0.02


def _linears(cls_j, cls_t, *shape, seed):
    jp.seed(seed)
    jlin = cls_j(*shape)
    tp.seed(seed)
    tlin = cls_t(*shape)
    np.testing.assert_array_equal(_np(tlin.weight), _np(jlin.weight))
    return jlin, tlin


def case_from_linear_conversion():
    jlin, tlin = _linears(jp.nn.Linear, tp.nn.Linear, 64, 32, seed=3)
    jql = JQ.WeightOnlyLinear.from_linear(jlin)
    tql = TQ.WeightOnlyLinear.from_linear(tlin)
    np.testing.assert_array_equal(_np(tql.weight), _np(jql.weight))
    x = np.random.RandomState(3).randn(2, 64).astype(np.float32)
    np.testing.assert_allclose(_np(tql(_tt(x))), _np(jql(_jt(x))), **OUT)
    ref = _np(tlin(_tt(x)))
    assert np.abs(_np(tql(_tt(x))) - ref).max() / np.abs(ref).max() < 0.02
    assert tql.weight.stop_gradient and not tql.weight.requires_grad


def case_quantize_stacked_params():
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    jparams = JL.init_stacked_params(jcfg, seed=0)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    params = TL.params_from_numpy(_tq(jparams), cfg, "cpu")
    jqp = JQ.quantize_stacked_params(jparams)
    qp = TQ.quantize_stacked_params(params)
    assert qp["embed"] is params["embed"]
    for k, v in jqp.items():
        if isinstance(v, dict):
            assert qp[k]["q"].dtype == torch.int8
            np.testing.assert_array_equal(_np(qp[k]["q"]), _np(v["q"]), k)
            np.testing.assert_array_equal(_np(qp[k]["scale"]),
                                          _np(v["scale"]), k)
    assert tuple(qp["wq"]["scale"].shape) == (2, 64)


def _gen_tokens(qparams_j, qparams_t, prompt, max_new=6):
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    want = JD.llama_engine(jcfg, JD.GenerationConfig(
        max_new_tokens=max_new)).generate(qparams_j, prompt)
    got = TD.llama_engine(cfg, TD.GenerationConfig(
        max_new_tokens=max_new), device="cpu").generate(qparams_t, prompt)
    return np.asarray(got), np.asarray(want)


def case_quantized_params_drive_generation():
    jparams = JL.init_stacked_params(JL.llama_tiny(num_hidden_layers=2),
                                     seed=4)
    jqp = JQ.quantize_stacked_params(jparams)
    qp = TL.params_from_numpy(_tq(jqp), TL.llama_tiny(num_hidden_layers=2),
                              "cpu")
    prompt = np.array([[3, 1, 4, 1, 5]], np.int32)
    got, want = _gen_tokens(jqp, qp, prompt)
    np.testing.assert_array_equal(got, want)
    fp = TL.params_from_numpy(_tq(jparams),
                              TL.llama_tiny(num_hidden_layers=2), "cpu")
    got_fp, _ = _gen_tokens(jparams, fp, prompt)
    assert (got_fp == got).mean() >= 0.5


def case_unknown_weight_dtype_raises():
    x = _tt(np.ones((2, 4), np.float32))
    q = _tt(np.zeros((4, 4), np.int8))
    s = _tt(np.ones(4, np.float32))
    with pytest.raises(ValueError, match="weight_dtype"):
        TQ.weight_only_linear(x, q, s, weight_dtype="bf16")
    with pytest.raises(ValueError, match="even in_features"):
        TQ.WeightOnlyLinear(65, 8, weight_dtype="int4")


def case_from_linear_accepts_long_alias():
    jlin, tlin = _linears(jp.nn.Linear, tp.nn.Linear, 16, 8, seed=6)
    jq = JQ.WeightOnlyLinear.from_linear(jlin, weight_dtype="weight_only_int8")
    q = TQ.WeightOnlyLinear.from_linear(tlin, weight_dtype="weight_only_int8")
    x = np.ones((2, 16), np.float32)
    np.testing.assert_allclose(_np(q(_tt(x))), _np(jq(_jt(x))), **OUT)


def case_stacked_scale_dequant_broadcast():
    jparams = JL.init_stacked_params(JL.llama_tiny(num_hidden_layers=2),
                                     seed=0)
    jqp = JQ.quantize_stacked_params(jparams)
    qp = TQ.quantize_stacked_params({"wq": torch.from_numpy(
        np.asarray(jparams["wq"]))})
    wd = _np(TQ.weight_dequantize(qp["wq"]["q"], qp["wq"]["scale"]))
    assert wd.shape == jparams["wq"].shape
    np.testing.assert_array_equal(
        wd, _np(JQ.weight_dequantize(jqp["wq"]["q"], jqp["wq"]["scale"])))


def case_int4_stacked_dequant_matches_per_layer():
    rng = np.random.RandomState(7)
    ws = [rng.randn(8, 6).astype(np.float32) for _ in range(3)]
    qs, ss = zip(*(TQ.weight_quantize(torch.from_numpy(w),
                                      "weight_only_int4") for w in ws))
    jqs, jss = zip(*(JQ.weight_quantize(w, "weight_only_int4") for w in ws))
    stacked = _np(TQ.weight_dequantize(torch.stack(qs), torch.stack(ss),
                                       "weight_only_int4"))
    jstacked = _np(JQ.weight_dequantize(jnp.stack(jqs), jnp.stack(jss),
                                        "weight_only_int4"))
    np.testing.assert_array_equal(stacked, jstacked)
    for i, (q, s) in enumerate(zip(qs, ss)):
        one = _np(TQ.weight_dequantize(q, s, "weight_only_int4"))
        np.testing.assert_array_equal(stacked[i], one)
        assert one.shape == (8, 6)


def _float_stacks(layers=2, h=32, ff=64, heads=4):
    """The reference test's float stack (seed 0, projection weights
    redrawn at 0.05 scale) in both packages, the port's carried by
    ``set_state_dict``."""
    jp.seed(0)
    jm = JFMT(h, heads, ff, num_layers=layers)
    rs = np.random.RandomState(0)
    for plist in (jm.qkv_weights, jm.linear_weights, jm.ffn1_weights,
                  jm.ffn2_weights):
        for p in plist:
            p._value = jnp.asarray(rs.randn(*p.shape) * 0.05, jnp.float32)
    tm = TFMT(h, heads, ff, num_layers=layers, device="cpu")
    missing, unexpected = tm.set_state_dict(
        {k: _np(v) for k, v in jm.state_dict().items()})
    assert not missing and not unexpected
    return jm, tm


def case_fmt_int8_prefill_tracks_float_stack():
    jm, tm = _float_stacks()
    jq, q = JFMT8.from_float(jm), TFMT8.from_float(tm)
    for (jk, jv), (k, v) in zip(jq.state_dict().items(),
                                q.state_dict().items()):
        assert jk == k
        np.testing.assert_array_equal(_np(v), _np(jv), k)
    x = np.random.RandomState(1).randn(2, 8, 32).astype(np.float32)
    got = _np(q(torch.from_numpy(x)))
    np.testing.assert_allclose(got, _np(jq(_jt(x))), **OUT)
    ref = _np(tm(torch.from_numpy(x)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05
    assert not np.allclose(got, ref, rtol=1e-6, atol=1e-7)


def case_fmt_int8_decode_consistent_with_prefill():
    jm, tm = _float_stacks()
    jq, q = JFMT8.from_float(jm), TFMT8.from_float(tm)
    S = 6
    x = np.random.RandomState(2).randn(1, S, 32).astype(np.float32)
    full = _np(q(torch.from_numpy(x)))
    _, cache = q(torch.from_numpy(x[:, :S - 1]), gen_cache_len=S)
    step, cache = q(torch.from_numpy(x[:, S - 1:]), caches=cache,
                    time_step=S - 1)
    _, jcache = jq(_jt(x[:, :S - 1]), gen_cache_len=S)
    jstep, jcache = jq(_jt(x[:, S - 1:]), caches=jcache, time_step=S - 1)
    np.testing.assert_allclose(_np(step), _np(jstep), **OUT)
    np.testing.assert_allclose(_np(cache), _np(jcache), **OUT)
    np.testing.assert_allclose(_np(step)[:, 0], full[:, -1], rtol=2e-2,
                               atol=2e-2)


def case_fmt_int8_calibrated_in_scales_used():
    jm, tm = _float_stacks(layers=1)
    cal = dict(qkv_in_scale=[1e-6], linear_in_scale=[1e-6],
               ffn1_in_scale=[1e-6], ffn2_in_scale=[1e-6])
    x = np.random.RandomState(3).randn(2, 4, 32).astype(np.float32)
    a = _np(TFMT8.from_float(tm)(torch.from_numpy(x)))
    b = _np(TFMT8.from_float(tm, **cal)(torch.from_numpy(x)))
    np.testing.assert_allclose(
        b, _np(JFMT8.from_float(jm, **cal)(_jt(x))), **OUT)
    assert not np.allclose(a, b, rtol=1e-3, atol=1e-3)


def case_fmt_int8_calibrated_scale_convention_matches_dynamic():
    rs = np.random.RandomState(4)
    x = rs.randn(1, 32).astype(np.float32)
    wq = rs.randint(-127, 128, (32, 16)).astype(np.int8)
    ws = (np.abs(rs.randn(16)).astype(np.float32) * 0.01)
    amax = float(np.abs(x).max())
    t = [torch.from_numpy(a) for a in (x, wq, ws)]
    dyn = _np(TB._int8_mm(*t))
    cal = _np(TB._int8_mm(*t, in_scale=amax))
    np.testing.assert_allclose(cal, dyn, rtol=1e-6, atol=1e-6)
    jdyn = _np(JB._int8_mm(*(jnp.asarray(a) for a in (x, wq, ws))))
    np.testing.assert_array_equal(dyn, jdyn)


def _nets(seed=0):
    """The reference test's 8-16-4 MLP in both packages from one seed
    (both draw the same weights from their key streams)."""
    out = []
    for pkg in (jp, tp):
        pkg.seed(seed)
        out.append(pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                                     pkg.nn.Linear(16, 4)))
    for (_, a), (_, b) in zip(out[0].state_dict().items(),
                              out[1].state_dict().items()):
        np.testing.assert_array_equal(_np(b), _np(a))
    return out


def case_qat_quantize_swaps_configured_linears():
    for pkg, Q in ((jp, JQ), (tp, TQ)):
        pkg.seed(0)
        net = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                                pkg.nn.Linear(16, 4))
        Q.QAT(Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax)).quantize(net)
        assert [n for n, _ in Q.quanted_layers(net)] == ["0", "2"]


def _train_step(pkg, net, x, y, steps):
    opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                              parameters=net.parameters())
    step = pkg.jit.TrainStep(net, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                             opt)
    return [float(_np(step(x, y))) for _ in range(steps)]


def _ste_grads(net, x, y):
    """Each activation quanter's input and output gradients, and the
    parameters' gradients, after one eager backward."""
    seen = []
    for _, ql in TQ.quanted_layers(net):
        ql.activation_quanter.register_full_backward_hook(
            lambda m, gin, gout: seen.append((gin[0], gout[0])))
    xt = torch.from_numpy(x)
    ((net(xt) - torch.from_numpy(y)) ** 2).mean().backward()
    return seen, {n: p.grad for n, p in net.named_parameters()}


def case_qat_fake_quant_close_to_float_and_ste_trains():
    """After five calibrating forwards the fake-quant outputs are the
    reference's; one step of the compiled trainer gives its loss, and
    the straight-through gradient trains. The gradient passes each
    activation quanter unchanged (the STE) and reaches the Linear before
    it; the reference's quanter returns a fresh Tensor, which gives that
    Linear no gradient (ROADMAP, "not port faults"), so the trajectories
    part after the first step and the gradients of the last layer are
    held to the reference's."""
    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype(np.float32)
    y = rs.randn(32, 4).astype(np.float32)
    outs, firsts = [], []
    for (net, pkg, Q, t) in zip(_nets(), (jp, tp), (JQ, TQ), (_jt, _tt)):
        ref = _np(net(t(x)))
        Q.QAT(Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax)).quantize(net)
        for _ in range(5):
            out = net(t(x))          # calibrates the moving-average scales
        assert np.abs(_np(out) - ref).max() / np.abs(ref).max() < 0.05
        outs.append(_np(out))
        losses = _train_step(pkg, net, t(x), t(y), 26)
        firsts.append(losses[0])
    np.testing.assert_allclose(outs[1], outs[0], **OUT)
    np.testing.assert_allclose(firsts[1], firsts[0], rtol=1e-6)
    assert losses[-1] < losses[0]
    jnet, net = _nets()
    for n, Q in ((jnet, JQ), (net, TQ)):
        Q.QAT(Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax)).quantize(n)
    seen, grads = _ste_grads(net, x, y)
    for gin, gout in seen[:1]:                  # the hidden layer's quanter
        torch.testing.assert_close(gin, gout, rtol=0, atol=0)
    assert float(grads["0.inner.weight"].abs().sum()) > 0
    loss = ((jnet(_jt(x)) - _jt(y)) ** 2).mean()
    loss.backward()
    for n, p in jnet.named_parameters():
        if n.startswith("2."):
            np.testing.assert_allclose(_np(grads[n]), _np(p.grad), **OUT)


def case_qat_convert_lowers_to_weight_only():
    x = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    outs = []
    for (net, Q, t) in zip(_nets(), (JQ, TQ), (_jt, _tt)):
        q = Q.QAT(Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax))
        q.quantize(net)
        fq = _np(net(t(x)))
        q.convert(net)
        kinds = [type(s).__name__ for _, s in net.named_sublayers()]
        assert kinds.count("WeightOnlyLinear") == 2
        out = _np(net(t(x)))
        assert np.abs(out - fq).max() / np.abs(fq).max() < 0.05
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], **OUT)


def _ptq_nets():
    out = []
    for pkg in (jp, tp):
        pkg.seed(0)
        out.append(pkg.nn.Sequential(pkg.nn.Linear(8, 8),
                                     pkg.nn.Linear(8, 2)))
    return out


def case_ptq_observer_flow():
    x = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    res = []
    for (net, Q, t) in zip(_ptq_nets(), (JQ, TQ), (_jt, _tt)):
        p = Q.PTQ()
        p.quantize(net)
        ref = _np(net(t(x)))
        for _ in range(3):
            net(t(x))
        obs = [s for _, s in net.named_sublayers()
               if isinstance(s, Q.AbsmaxObserver)]
        assert obs and all(o.scale > 0 for o in obs)
        scales = [o.scale for o in obs]
        p.convert(net)
        out = _np(net(t(x)))
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.05
        res.append((scales, out))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    np.testing.assert_allclose(res[1][1], res[0][1], **OUT)


def case_qat_name_and_type_config():
    for (net, Q) in zip(_nets(), (JQ, TQ)):
        cfg = Q.QuantConfig().add_name_config(
            "0", activation=Q.FakeQuanterWithAbsMax)
        Q.QAT(cfg).quantize(net)
        assert [n for n, _ in Q.quanted_layers(net)] == ["0"]
    net = _nets()[1]
    cfg = TQ.QuantConfig().add_type_config(
        tp.nn.Linear, activation=TQ.FakeQuanterWithAbsMax, weight=4)
    TQ.QAT(cfg).quantize(net)
    assert [q.weight_bits for _, q in TQ.quanted_layers(net)] == [4, 4]


def case_qat_cold_start_compiled_qat_calibrates():
    """A QAT net whose first forwards run in the compiled step
    (``jit.TrainStep``) still calibrates: the scale buffers are written
    inside the step, as BatchNorm's running statistics are."""
    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype(np.float32)
    y = rs.randn(32, 4).astype(np.float32)
    runs = []
    for (net, pkg, Q, t) in zip(_nets(), (jp, tp), (JQ, TQ), (_jt, _tt)):
        Q.QAT(Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax)).quantize(net)
        first = _train_step(pkg, net, t(x), t(y), 1)[0]
        scales = [float(_np(ql.activation_quanter.scale))
                  for _, ql in Q.quanted_layers(net)]
        losses = _train_step(pkg, net, t(x), t(y), 20)
        assert all(s > 0 for s in scales) and losses[-1] < first
        runs.append((first, scales))
    # the first compiled step calibrates from the same weights: the same
    # loss and scales (the gradients part later: see the case above)
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-6)


def case_qat_weight_bits_config_respected():
    for (net, Q) in zip(_nets(), (JQ, TQ)):
        cfg = Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax, weight=4)
        Q.QAT(cfg).quantize(net)
        assert all(q.weight_bits == 4 for _, q in Q.quanted_layers(net))
        with pytest.raises(ValueError, match="weight quanter"):
            Q.QuantConfig(weight="int8")
    x = np.random.RandomState(5).randn(4, 8).astype(np.float32)
    nets = _nets()
    for net, Q in zip(nets, (JQ, TQ)):
        Q.QAT(Q.QuantConfig(activation=Q.FakeQuanterWithAbsMax,
                            weight=4)).quantize(net)
    np.testing.assert_allclose(_np(nets[1](_tt(x))), _np(nets[0](_jt(x))),
                               **OUT)


def case_ptq_scales_reach_converted_layers():
    x = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    got = []
    for (net, Q, t) in zip(_ptq_nets(), (JQ, TQ), (_jt, _tt)):
        p = Q.PTQ()
        p.quantize(net)
        for _ in range(3):
            net(t(x))
        scales = p.activation_scales(net)
        assert scales and all(v > 0 for v in scales.values())
        p.convert(net)
        got.append({n: s.act_scale for n, s in net.named_sublayers()
                    if type(s).__name__ == "WeightOnlyLinear"})
    assert got[1].keys() == got[0].keys()
    np.testing.assert_allclose([got[1][k] for k in sorted(got[1])],
                               [got[0][k] for k in sorted(got[0])],
                               rtol=1e-6)


REF_CASES = {n[len("case_"):]: f for n, f in dict(globals()).items()
             if n.startswith("case_")}


@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_reference_case(name):
    REF_CASES[name]()


def test_reference_cases_are_the_jax_files():
    """One case for each of the JAX file's 22 tests."""
    assert len(REF_CASES) == 22


# ---------------------------------------------------------------------------
# nn.quant, the int8 fused stack's calibrated end-to-end case, bytes
# ---------------------------------------------------------------------------

def test_nn_quant_names_are_quantizations():
    from paddle_tpu_torch.nn import quant
    assert quant.weight_quantize is TQ.weight_quantize
    assert quant.WeightOnlyLinear is TQ.WeightOnlyLinear
    assert set(quant.__all__) == {"weight_only_linear", "weight_quantize",
                                  "weight_dequantize", "WeightOnlyLinear"}


def test_int8_encoder_calibrated_range_scales_end_to_end():
    """``tests/test_advice_r3_fixes.py``'s case: range-convention
    calibrated scales track the float stack, and the port's output is
    the reference's."""
    jm, tm = _float_stacks()
    # x is the reference's next draw after the eight weight redraws
    rs = np.random.RandomState(0)
    for shape in ((32, 96), (32, 32), (32, 64), (64, 32)):
        rs.randn(*shape), rs.randn(*shape)
    x = rs.randn(2, 8, 32).astype(np.float32)
    cal = dict(qkv_in_scale=[3.0, 3.0], linear_in_scale=[3.0, 3.0],
               ffn1_in_scale=[3.0, 3.0], ffn2_in_scale=[3.0, 3.0])
    got = _np(TFMT8.from_float(tm, **cal)(torch.from_numpy(x)))
    ref = _np(tm(torch.from_numpy(x)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.1
    np.testing.assert_allclose(got, _np(JFMT8.from_float(jm, **cal)(_jt(x))),
                               **OUT)


@pytest.mark.parametrize("bits", ["weight_only_int8", "weight_only_int4"])
def test_quantized_bytes_bitwise(bits):
    """Quantized bytes equal the reference's bit for bit, extreme values
    included (a column of zeros, ±amax, exact halves of a step)."""
    rs = np.random.RandomState(11)
    w = rs.randn(32, 24).astype(np.float32)
    w[:, 0] = 0.0
    w[3, 1], w[5, 1] = 7.0, -7.0
    w[:, 2] = np.arange(32, dtype=np.float32) - 15.5
    jq, js = JQ.weight_quantize(w, bits)
    q, s = TQ.weight_quantize(w, bits, device="cpu")
    np.testing.assert_array_equal(_np(q).view(np.uint8),
                                  _np(jq).view(np.uint8))
    np.testing.assert_array_equal(_np(s), _np(js))
    np.testing.assert_array_equal(_np(TQ.weight_dequantize(q, s, bits)),
                                  _np(JQ.weight_dequantize(jq, js, bits)))


def test_int8_weights_count_their_bytes():
    """The memory ledger and ``params_key`` walk int8 leaves: an int8
    projection counts one byte an element plus its fp32 scales."""
    from paddle_tpu_torch.inference.graphs import params_key
    w = torch.randn(2, 64, 32)
    qp = TQ.quantize_stacked_params({"wq": w})
    assert pytree_nbytes(qp) == 2 * 64 * 32 + 2 * 32 * 4
    key = params_key(qp)
    assert key[0][0] == "wq" and len(key[0][1]) == 2


# ---------------------------------------------------------------------------
# quantized Llama through the serving engines: the JAX engine's tokens
# ---------------------------------------------------------------------------

JCFG = JL.llama_tiny(num_hidden_layers=2)
CFG = TL.llama_tiny(num_hidden_layers=2)
JQP = JQ.quantize_stacked_params(JL.init_stacked_params(JCFG, seed=3))
QP = TL.params_from_numpy(_tq(JQP), CFG, "cpu")
GEO = dict(num_slots=2, page_size=4, max_seq_len=64, chunk=3)


def _prompts(n=5, lens=(5, 12, 3, 9, 7), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _flag(pkg, on: bool):
    pkg.set_flags({"FLAGS_serving_a8w8_prefill": int(on)})


@pytest.mark.parametrize("a8w8", [True, False], ids=["a8w8", "weight_only"])
@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_quantized_llama_serves_the_jax_engines_tokens(unified, a8w8):
    """Greedy streams of the int8 model (all eight keys quantized) on
    both pipelines, with FLAGS_serving_a8w8_prefill on and off, equal
    the JAX engine's."""
    prompts = _prompts()
    for pkg in (jp, tp):
        _flag(pkg, a8w8)
    try:
        jeng = JD.ContinuousBatchingEngine(
            JCFG, JD.GenerationConfig(max_new_tokens=6), unified=unified,
            **GEO)
        teng = TD.ContinuousBatchingEngine(
            CFG, TD.GenerationConfig(max_new_tokens=6), unified=unified,
            device="cpu", **GEO)
        assert teng.serve(QP, prompts) == jeng.serve(JQP, prompts)
    finally:
        for pkg in (jp, tp):
            _flag(pkg, True)


def test_a8w8_flag_flip_recaptures_the_unified_step():
    """``test_continuous_batching.py::test_a8w8_flag_flip_retraces_
    unified_step``: a flip of FLAGS_serving_a8w8_prefill builds a new
    unified program, one counted miss, whose key carries the flag; the
    int8 streams follow the flag (each equal to an engine that only saw
    that setting)."""
    prompts = _prompts(2)
    teng = TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(max_new_tokens=4), device="cpu", **GEO)
    on = teng.serve(QP, prompts)
    prog = teng._unified_step
    before = recompiles.count("cbe.unified_step")
    _flag(tp, False)
    try:
        off = teng.serve(QP, prompts)
        assert teng._unified_step is not prog
        assert recompiles.count("cbe.unified_step") == before + 1
        assert [k[7] for _, k in teng.compile_misses] == [True, False]
        fresh = TD.ContinuousBatchingEngine(
            CFG, TD.GenerationConfig(max_new_tokens=4), device="cpu", **GEO)
        assert fresh.serve(QP, prompts) == off
        again = teng.serve(QP, prompts)
        assert teng._unified_step is not None and again == off
        assert len(teng.compile_misses) == 2        # the same program
    finally:
        _flag(tp, True)
    assert teng.serve(QP, prompts) == on
    assert len(teng.compile_misses) == 3


def test_quantized_llama_at_mp2_serves_the_jax_engines_tokens():
    """The int8 model over a 2-chip serving mesh (column-parallel
    A8W8 products on each chip's slab, ``wo``'s int32 partials summed
    across the chips) gives the JAX engine's greedy tokens at mp 2 and
    the one-chip port's."""
    prompts = _prompts()
    jeng = JD.ContinuousBatchingEngine(
        JCFG, JD.GenerationConfig(max_new_tokens=6),
        mesh=jmesh.serving_mesh(2), **GEO)
    teng = TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(max_new_tokens=6),
        mesh=tmesh.serving_mesh(2, [CPU] * 2), device="cpu", **GEO)
    one = TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(max_new_tokens=6), device="cpu", **GEO)
    got = teng.serve(QP, prompts)
    assert got == jeng.serve(JQP, prompts)
    assert got == one.serve(QP, prompts)


def test_int8_train_step_refuses_the_int8_leaves():
    step, _ = TL.build_train_step(CFG, device="cpu")
    ids = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="no gradient"):
        step(QP, TL.init_opt_state({"embed": QP["embed"]}), ids, ids)


def test_forward_stacked_with_int8_leaves_matches_jax():
    """The training-side forward (``forward_stacked``) dequantizes each
    int8 weight in its product, as the reference's ``_dense`` does."""
    ids = np.random.RandomState(4).randint(1, 256, (2, 7)).astype(np.int32)
    want = JL.forward_stacked(JQP, jnp.asarray(ids), JCFG)
    got = TL.forward_stacked(QP, torch.from_numpy(ids), CFG)
    np.testing.assert_allclose(_np(got), _np(want), **OUT)


@pytest.mark.parametrize("shape", [(100, 260), (12, 8), (3, 7, 5),
                                   (256, 96)])
def test_col_major_pads_to_multiples_of_8(shape):
    """``col_major`` keeps the values and shape, lays them out
    column-major in a buffer zero-padded to K and N multiples of 8, and
    ``int32_product``'s padded operand is that buffer, uncopied, whose
    ``[:K, :N]`` is the weight; a weight laid out otherwise gets a fresh
    padded copy with the same leading block."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    c = TB.col_major(w)
    assert c.shape == w.shape and torch.equal(c, w)
    k, n = shape[-2:]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert c.stride()[-2:] == (1, kp)
    layers = [c] if c.dim() == 2 else list(c)
    for layer, orig in zip(layers, [w] if w.dim() == 2 else list(w)):
        op = TB._padded_operand(layer, kp, np_)
        assert op.shape == (kp, np_)
        assert op.untyped_storage().data_ptr() == \
            c.untyped_storage().data_ptr()
        assert torch.equal(op[:k, :n], orig)
        assert not op[k:].any() and not op[:, n:].any()
        fresh = TB._padded_operand(orig.contiguous(), kp, np_)
        assert fresh.untyped_storage().data_ptr() != \
            orig.untyped_storage().data_ptr()
        assert torch.equal(fresh[:k, :n], orig)
