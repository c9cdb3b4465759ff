"""``jit.save``/``jit.load`` and the inference ``Config``/``Predictor`` of
``paddle_tpu_torch`` against ``paddle_tpu``'s on the CPU: the reference's
scenarios (the jit, predictor and config tests of
``tests/test_inference.py``, written out with ``Config.disable_gpu()``:
the port's default device is the card) and the same seeded layers and
inputs through both packages (outputs within rtol 1e-5, atol 1e-6). The
saved program is a ``torch.export`` program whose LayerNorm, RMSNorm and
flash-attention forwards are the port's custom ops (rows 8, 1 and 5);
the ``.pdiparams.npz`` crosses between the packages in both directions,
and a ``.pdmodel`` of the reference raises and names its format. fp32."""

import math

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


def _mlp(pkg):
    pkg.seed(7)
    nn = pkg.nn
    return nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.LayerNorm(16),
                         nn.Linear(16, 3))


def _cpu_config(prefix):
    c = TP.inference.config.Config(prefix)
    c.disable_gpu()
    return c


def test_jit_save_load_roundtrip(tmp_path):
    net = _mlp(TP)
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    ref = _np(net(TP.to_tensor(x)))
    prefix = str(tmp_path / "model")
    TP.jit.save(net, prefix, input_spec=[TP.static.InputSpec([2, 4],
                                                              "float32")])
    loaded = TP.jit.load(prefix)
    np.testing.assert_allclose(_np(loaded(x)), ref, rtol=1e-5)
    assert loaded.n_outputs == 1
    assert [tuple(s.shape) for s in loaded.input_spec] == [(2, 4)]
    with pytest.raises(RuntimeError, match="inference program"):
        loaded.train()


def test_predictor_handles(tmp_path):
    from paddle_tpu_torch.inference.predictor import create_predictor
    net = _mlp(TP)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    ref = _np(net(TP.to_tensor(x)))
    prefix = str(tmp_path / "model")
    TP.jit.save(net, prefix, input_spec=[TP.static.InputSpec([2, 4],
                                                              "float32")])
    predictor = create_predictor(_cpu_config(prefix + ".pdmodel"))
    names = predictor.get_input_names()
    assert names == ["x0"]
    h = predictor.get_input_handle(names[0])
    h.copy_from_cpu(x)
    assert h.shape() == (2, 4)
    assert predictor.run() is True
    out_names = predictor.get_output_names()
    out = predictor.get_output_handle(out_names[0]).copy_to_cpu()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    with pytest.raises(ValueError, match="inputs not set"):
        type(predictor)(_cpu_config(prefix)).run()


def test_predictor_direct_run_api_and_signatures(tmp_path):
    from paddle_tpu_torch.inference.predictor import create_predictor
    net = _mlp(TP)
    prefix = str(tmp_path / "m2")
    TP.jit.save(net, prefix, input_spec=[TP.static.InputSpec([2, 4],
                                                              "float32")])
    predictor = create_predictor(_cpu_config(prefix))
    for _ in range(3):
        outs = predictor.run([np.ones((2, 4), np.float32)])
    assert len(outs) == 1 and outs[0].shape == (2, 3)
    # one program signature for the three runs
    assert predictor.guard.recompile_count == 0
    assert len(predictor.guard._sigs) == 1


def test_config_parity_knobs():
    from paddle_tpu_torch.inference.config import Config
    for pkg_config in (J.inference.Config, Config):
        c = pkg_config("m.pdmodel")
        c.enable_use_gpu(100, 0)
        assert c.use_gpu()
        c.enable_tensorrt_engine(workspace_size=1 << 30)
        c.switch_ir_optim(False)
        assert "ir_optim=False" in c.summary()
        assert c.prog_file() == "m.pdmodel"
        assert c.params_file() == "m.pdiparams"
        c.disable_gpu()
        assert not c.use_gpu()
    c = Config("m")
    # the port's default device is the card (the reference's is "tpu")
    assert c.use_gpu() and c.torch_device() == torch.device("cuda", 0)
    c.disable_gpu()
    assert c.torch_device() == torch.device("cpu")


def test_saved_program_matches_reference(tmp_path):
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    outs = []
    for pkg in (J, TP):
        net = _mlp(pkg)
        prefix = str(tmp_path / pkg.__name__ / "m")
        pkg.jit.save(net, prefix,
                     input_spec=[pkg.static.InputSpec([2, 4], "float32")])
        if pkg is J:
            pred = J.inference.create_predictor(J.inference.Config(prefix))
        else:
            pred = TP.inference.predictor.create_predictor(
                _cpu_config(prefix))
        outs.append(pred.run([x])[0])
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_pdiparams_cross_both_ways(tmp_path):
    """The reference's ``.pdiparams.npz`` loads into the port's program
    (and gives the reference's output), and the port's into the
    reference's (and gives the port's)."""
    x = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    jnet, tnet = _mlp(J), _mlp(TP)
    with torch.no_grad():
        for p in tnet.parameters():
            p.mul_(1.5)              # the port's weights differ
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    J.jit.save(jnet, jp, input_spec=[J.static.InputSpec([2, 4], "float32")])
    TP.jit.save(tnet, tp, input_spec=[TP.static.InputSpec([2, 4],
                                                           "float32")])
    want_j = np.asarray(jnet(J.to_tensor(x))._value)
    want_t = _np(tnet(TP.to_tensor(x)))
    jnpz, tnpz = (np.load(jp + ".pdiparams.npz"),
                  np.load(tp + ".pdiparams.npz"))
    assert sorted(jnpz.files) == sorted(tnpz.files)
    np.savez(str(tmp_path / "swap_t"), **{k: jnpz[k] for k in jnpz.files})
    np.savez(str(tmp_path / "swap_j"), **{k: tnpz[k] for k in tnpz.files})
    import shutil
    shutil.copy(str(tmp_path / "swap_t.npz"), tp + ".pdiparams.npz")
    shutil.copy(str(tmp_path / "swap_j.npz"), jp + ".pdiparams.npz")
    np.testing.assert_allclose(_np(TP.jit.load(tp)(x)), want_j, **TOL)
    np.testing.assert_allclose(np.asarray(J.jit.load(jp)(x)._value), want_t,
                               **TOL)


def test_reference_pdmodel_raises_naming_its_format(tmp_path):
    jp = str(tmp_path / "j")
    J.jit.save(_mlp(J), jp, input_spec=[J.static.InputSpec([2, 4],
                                                            "float32")])
    with pytest.raises(ValueError, match="stablehlo"):
        TP.jit.load(jp)


class _TinyLlamaLayer(TP.nn.Layer):
    """One pre-norm decoder layer over RMSNorm (row 1) and causal
    attention at head dim 64 (row 5's flash forward)."""

    def __init__(self, h=128, heads=2):
        super().__init__()
        self.heads = heads
        self.norm1 = TP.nn.RMSNorm(h)
        self.qkv = TP.nn.Linear(h, 3 * h)
        self.out = TP.nn.Linear(h, h)
        self.norm2 = TP.nn.RMSNorm(h)

    def forward(self, x):
        b, s, h = x.shape
        q, k, v = TP.split(self.qkv(self.norm1(x)), 3, axis=-1)
        shape = [b, s, self.heads, h // self.heads]
        a = TP.nn.functional.scaled_dot_product_attention(
            q.reshape(shape), k.reshape(shape), v.reshape(shape),
            is_causal=True)
        return self.norm2(x + self.out(a.reshape([b, s, h])))


def _exported_ops(prefix):
    prog = TP.jit.load(prefix)
    return {str(n.target) for n in prog._exported.graph.nodes
            if n.op == "call_function"}


def test_saved_programs_hold_the_kernel_rows_as_custom_ops(tmp_path):
    """A LayerNorm layer exports ``paddle_tpu_torch.layer_norm`` (row 8),
    the tiny Llama layer ``rms_norm`` (row 1) and
    ``flash_attention_fwd`` (row 5); loaded, they run the plain versions
    on the CPU and equal the layer's own forward."""
    TP.seed(0)
    mlp = _mlp(TP)
    TP.jit.save(mlp, str(tmp_path / "ln"),
                input_spec=[TP.static.InputSpec([2, 4], "float32")])
    assert "paddle_tpu_torch.layer_norm.default" in _exported_ops(
        str(tmp_path / "ln"))
    TP.seed(1)
    layer = _TinyLlamaLayer()
    x = np.random.RandomState(5).randn(2, 16, 128).astype(np.float32)
    ref = _np(layer(TP.to_tensor(x)))
    TP.jit.save(layer, str(tmp_path / "llama"),
                input_spec=[TP.static.InputSpec([2, 16, 128], "float32")])
    ops = _exported_ops(str(tmp_path / "llama"))
    assert {"paddle_tpu_torch.rms_norm.default",
            "paddle_tpu_torch.flash_attention_fwd.default"} <= ops
    got = TP.jit.load(str(tmp_path / "llama"))(x)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)
    # the custom ops are the plain versions on the CPU, bit for bit
    from paddle_tpu_torch.ops import rms_norm as rn
    t = torch.from_numpy(x[0])
    w = torch.ones(128)
    assert torch.equal(rn.rms_norm_op(t, w, 1e-6),
                       rn.rms_norm_plain(t, w, 1e-6))
    assert not math.isnan(float(_np(got).sum()))
