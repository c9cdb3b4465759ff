"""The layers of ``paddle_tpu_torch.nn`` against the JAX package's on the
CPU: initial weights from the key stream (the repair of the port's
torch-generator draws), every class of ``common_layers`` forward and
backward with the reference's weights carried across, ``nn.utils``, and
the reference's own scenarios of ``tests/test_nn.py`` and
``tests/test_nn_audit_ops.py`` run through the port
(``torch_scenarios``). fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

import torch_scenarios

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _grad(p):
    g = p.grad
    return None if g is None else _np(g)


# ---------------------------------------------------------------------------
# initial weights: the key stream, in construction order
# ---------------------------------------------------------------------------

def _seeded_layers(pkg):
    pkg.seed(11)
    nn = pkg.nn
    return [nn.Linear(5, 6), nn.Embedding(10, 4), nn.Conv2D(3, 4, 3),
            nn.LayerNorm(6), nn.TransformerEncoderLayer(8, 2, 16),
            nn.LSTM(4, 6, num_layers=2)]


def test_seeded_layers_draw_the_references_weights():
    ref, port = _seeded_layers(J), _seeded_layers(TP)
    for r, p in zip(ref, port):
        rn, pn = dict(r.named_parameters()), dict(p.named_parameters())
        assert list(pn) == list(rn), type(r).__name__
        for name, rv in rn.items():
            a, b = _np(rv), _np(pn[name])
            if isinstance(r, J.nn.Embedding):        # Normal(0, 1)
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                           err_msg=name)
            else:                                    # uniform draws, fills
                np.testing.assert_array_equal(b, a, err_msg=name)
    rc, rk = J.get_rng_state()
    pc, pk = TP.get_rng_state()
    assert pc == rc
    rk = jax.random.key_data(rk) if jnp.issubdtype(
        rk.dtype, jax.dtypes.prng_key) else rk
    np.testing.assert_array_equal(_np(pk).astype(np.uint32),
                                  np.asarray(rk).astype(np.uint32))


@pytest.mark.parametrize("init,args", [
    ("Constant", (0.5,)), ("Uniform", (-0.3, 0.7)), ("Normal", (0.2, 1.5)),
    ("TruncatedNormal", (0.1, 0.5)), ("XavierUniform", ()),
    ("XavierNormal", ()), ("KaimingUniform", ()), ("KaimingNormal", ()),
    ("Orthogonal", (1.3,)),
])
def test_initializers_draw_the_references_values(init, args):
    got = []
    for pkg in (J, TP):
        pkg.seed(5)
        make = getattr(pkg.nn.initializer, init)(*args)
        got.append([_np(make(shape, "float32"))
                    for shape in ((7, 9), (4, 3, 2, 2))])
        got[-1].append(pkg.get_rng_state()[0])
    (r1, r2, rc), (p1, p2, pc) = got
    assert pc == rc
    exact = init in ("Constant", "Uniform", "XavierUniform",
                     "KaimingUniform")
    for a, b in ((r1, p1), (r2, p2)):
        if exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-6)


def test_param_attr_sets_initializer_and_optimizer_attributes():
    for pkg in (J, TP):
        pkg.seed(0)
    attr = dict(initializer=None, learning_rate=0.5, trainable=False,
                need_clip=False)
    r = J.nn.Linear(3, 4, weight_attr=J.ParamAttr(
        **dict(attr, initializer=J.nn.initializer.Constant(0.25))))
    p = TP.nn.Linear(3, 4, weight_attr=TP.ParamAttr(
        **dict(attr, initializer=TP.nn.initializer.Constant(0.25))))
    np.testing.assert_array_equal(_np(p.weight), _np(r.weight))
    assert p.weight.optimize_attr == {"learning_rate": 0.5}
    assert not p.weight.requires_grad and p.weight.need_clip is False
    # an initializer alone, a name, and False
    q = TP.nn.Linear(3, 4, weight_attr=TP.nn.initializer.Constant(2.0),
                     bias_attr=False)
    assert q.bias is None and float(q.weight.sum()) == 24.0
    assert TP.nn.Linear(3, 4, weight_attr="w").weight.shape == (3, 4)


def test_layer_apply_to_and_full_name():
    net = TP.nn.Sequential(TP.nn.Linear(2, 3), TP.nn.ReLU())
    seen = []
    net.apply(lambda m: seen.append(type(m).__name__))
    assert seen == ["Sequential", "Linear", "ReLU"]      # pre-order
    assert net[0].full_name() == "linear"
    w = net[0].weight
    assert net.to("cpu", "float64") is net and w.dtype == torch.float64
    assert net.astype("float32")[0].weight is w and w.dtype == torch.float32


# ---------------------------------------------------------------------------
# every class of common_layers, weights carried across
# ---------------------------------------------------------------------------

R = np.random.RandomState(0)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _i(hi, *shape):
    return R.randint(0, hi, size=shape).astype(np.int32)


def _p(*shape):
    return R.uniform(0.05, 0.95, size=shape).astype(np.float32)


# (id, constructor, inputs, differentiable inputs)
LAYERS = [
    ("Linear", lambda nn: nn.Linear(5, 6), [_f(3, 5)], 1),
    ("Embedding", lambda nn: nn.Embedding(10, 4, padding_idx=0),
     [_i(10, 3, 5)], 0),
    ("Identity", lambda nn: nn.Identity(), [_f(2, 3)], 1),
    ("Flatten", lambda nn: nn.Flatten(), [_f(2, 3, 4)], 1),
    ("Dropout", lambda nn: nn.Dropout(0.3), [_f(4, 6)], 1),
    ("Dropout_axis", lambda nn: nn.Dropout(0.5, axis=1), [_f(4, 6)], 1),
    ("Dropout2D", lambda nn: nn.Dropout2D(0.5), [_f(2, 3, 4, 4)], 1),
    ("Upsample_nearest", lambda nn: nn.Upsample(scale_factor=2),
     [_f(1, 2, 3, 3)], 1),
    ("Upsample_bilinear", lambda nn: nn.Upsample(size=(5, 7),
                                                 mode="bilinear"),
     [_f(1, 2, 3, 4)], 1),
    ("Upsample_bicubic_down", lambda nn: nn.Upsample(size=(3, 2),
                                                     mode="bicubic"),
     [_f(1, 2, 6, 5)], 1),
    ("Conv1D", lambda nn: nn.Conv1D(3, 4, 3, padding=1), [_f(2, 3, 8)], 1),
    ("Conv2D", lambda nn: nn.Conv2D(3, 4, 3, stride=2, padding=1),
     [_f(2, 3, 7, 7)], 1),
    ("Conv2D_same_groups", lambda nn: nn.Conv2D(4, 4, 3, stride=2,
                                                padding="SAME", groups=2),
     [_f(1, 4, 6, 5)], 1),
    ("Conv2D_nhwc", lambda nn: nn.Conv2D(3, 2, (2, 3), padding=[1, 0, 2, 1],
                                         data_format="NHWC"),
     [_f(1, 5, 6, 3)], 1),
    ("Conv3D", lambda nn: nn.Conv3D(2, 3, 2), [_f(1, 2, 4, 4, 4)], 1),
    ("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(
        3, 2, 3, stride=2, padding=1, output_padding=1), [_f(1, 3, 4, 4)], 1),
    ("LayerNorm", lambda nn: nn.LayerNorm(6), [_f(3, 6)], 1),
    ("RMSNorm", lambda nn: nn.RMSNorm(6), [_f(3, 6)], 1),
    ("BatchNorm1D", lambda nn: nn.BatchNorm1D(4), [_f(5, 4)], 1),
    ("BatchNorm2D", lambda nn: nn.BatchNorm2D(3), [_f(2, 3, 4, 4)], 1),
    ("BatchNorm3D", lambda nn: nn.BatchNorm3D(2), [_f(2, 2, 3, 3, 3)], 1),
    ("BatchNorm", lambda nn: nn.BatchNorm(3), [_f(2, 3, 2, 2)], 1),
    ("SyncBatchNorm", lambda nn: nn.SyncBatchNorm(3), [_f(2, 3, 2, 2)], 1),
    ("GroupNorm", lambda nn: nn.GroupNorm(2, 4), [_f(2, 4, 3, 3)], 1),
    ("InstanceNorm2D", lambda nn: nn.InstanceNorm2D(3), [_f(2, 3, 4, 4)], 1),
    ("MaxPool2D", lambda nn: nn.MaxPool2D(2), [_f(2, 3, 4, 4)], 1),
    ("MaxPool2D_mask", lambda nn: nn.MaxPool2D(2, 2, return_mask=True),
     [_f(1, 2, 6, 4)], 1),
    ("AvgPool2D", lambda nn: nn.AvgPool2D(3, 2, 1), [_f(2, 3, 6, 6)], 1),
    ("AvgPool2D_inclusive", lambda nn: nn.AvgPool2D(
        2, 2, 1, exclusive=False), [_f(1, 2, 5, 5)], 1),
    ("AdaptiveAvgPool2D", lambda nn: nn.AdaptiveAvgPool2D(2),
     [_f(2, 3, 4, 6)], 1),
    ("AdaptiveMaxPool2D", lambda nn: nn.AdaptiveMaxPool2D(2),
     [_f(2, 3, 4, 6)], 1),
] + [
    (name, (lambda n: lambda nn: getattr(nn, n)())(name), [_f(3, 7)], 1)
    for name in ("ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Mish", "Sigmoid",
                 "Tanh", "Hardswish", "Hardsigmoid", "Hardtanh", "ELU",
                 "SELU", "CELU", "Softplus", "Softsign", "Tanhshrink",
                 "Hardshrink", "Softshrink", "LogSoftmax", "LeakyReLU",
                 "PReLU", "Softmax")
] + [
    ("CrossEntropyLoss", lambda nn: nn.CrossEntropyLoss(),
     [_f(4, 5), _i(5, 4)], 1),
    ("CrossEntropyLoss_smooth_weight", lambda nn, w=_p(5):
     nn.CrossEntropyLoss(weight=w, reduction="sum", label_smoothing=0.1),
     [_f(4, 5), _i(5, 4)], 1),
    ("CrossEntropyLoss_soft_axis", lambda nn: nn.CrossEntropyLoss(
        soft_label=True, axis=1, reduction="none"),
     [_f(3, 4, 2), _p(3, 4, 2)], 1),
    ("MSELoss", lambda nn: nn.MSELoss(), [_f(3, 4), _f(3, 4)], 2),
    ("L1Loss", lambda nn: nn.L1Loss("sum"), [_f(3, 4), _f(3, 4)], 2),
    ("NLLLoss", lambda nn: nn.NLLLoss(ignore_index=1),
     [_f(4, 5), _i(5, 4)], 1),
    ("BCELoss", lambda nn: nn.BCELoss(), [_p(3, 4), _p(3, 4).round()], 1),
    ("BCEWithLogitsLoss", lambda nn, w=_p(4): nn.BCEWithLogitsLoss(
        pos_weight=w), [_f(3, 4), _p(3, 4).round()], 1),
    ("SmoothL1Loss", lambda nn: nn.SmoothL1Loss(delta=0.5),
     [_f(3, 4), _f(3, 4)], 2),
    ("KLDivLoss", lambda nn: nn.KLDivLoss("batchmean"),
     [_f(3, 4), _p(3, 4)], 1),
    ("Pad2D_reflect", lambda nn: nn.Pad2D([1, 2, 0, 1], mode="reflect"),
     [_f(1, 2, 4, 4)], 1),
    ("Pad2D_replicate", lambda nn: nn.Pad2D(1, mode="replicate"),
     [_f(1, 2, 3, 3)], 1),
    ("PixelShuffle", lambda nn: nn.PixelShuffle(2), [_f(1, 8, 2, 3)], 1),
]


def _tensor(pkg, a, grad):
    return pkg.to_tensor(a, stop_gradient=not grad)


@pytest.mark.parametrize("name,make,inputs,n_grad", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_the_reference(name, make, inputs, n_grad):
    ref = make(J.nn)
    port = make(TP.nn)
    port.set_state_dict({k: _np(v) for k, v in ref.state_dict().items()})
    outs, grads = [], []
    for pkg, layer in ((J, ref), (TP, port)):
        xs = [_tensor(pkg, a, i < n_grad) for i, a in enumerate(inputs)]
        pkg.seed(9)                       # the same dropout masks
        out = layer(*xs)
        first = out[0] if isinstance(out, tuple) else out
        cot = np.asarray(np.random.RandomState(2).randn(*first.shape),
                         np.float32)
        if first.dtype in (J.float32, TP.float32):
            (first * pkg.to_tensor(cot)).sum().backward()
        outs.append([_np(o) for o in (out if isinstance(out, tuple)
                                      else (out,))])
        grads.append([_np(x.grad) if x.grad is not None else None
                      for x in xs[:n_grad]]
                     + [_grad(p) for p in layer.parameters()])
        grads[-1] += [_np(b) for _, b in layer.state_dict().items()
                      if "_mean" in _ or "_variance" in _]
    for r, p in zip(*outs):
        np.testing.assert_allclose(p, r, **TOL)
    for r, p in zip(*grads):
        assert (r is None) == (p is None)
        if r is not None:
            np.testing.assert_allclose(p, r, **TOL)


def test_padded_max_pool_mask_holds_input_positions():
    """With padding (and ``ceil_mode``'s extra row) the mask is each
    window's argmax as a flat position of the unpadded input. The
    reference's own mask is wrong there (ROADMAP, behaviours of the
    reference): its patches of the −inf padding multiply −inf by 0."""
    x = _f(1, 2, 6, 5)
    out, mask = TP.nn.MaxPool2D(3, 2, 1, ceil_mode=True, return_mask=True)(
        TP.to_tensor(x))
    out, mask = _np(out), _np(mask)
    assert out.shape == mask.shape == (1, 2, 4, 3)
    flat = x.reshape(1, 2, -1)
    for c in range(2):
        for i in range(4):
            for j in range(3):
                r0, c0 = max(2 * i - 1, 0), max(2 * j - 1, 0)
                win = x[0, c, r0:2 * i + 2, c0:2 * j + 2]
                assert out[0, c, i, j] == win.max()
                assert flat[0, c, mask[0, c, i, j]] == win.max()
    np.testing.assert_allclose(
        out, _np(J.nn.MaxPool2D(3, 2, 1, ceil_mode=True)(J.to_tensor(x))))


def test_max_unpool_inverts_the_pool_mask():
    x = _f(1, 2, 4, 6)
    outs = []
    for pkg in (J, TP):
        out, mask = pkg.nn.MaxPool2D(2, return_mask=True)(pkg.to_tensor(x))
        outs.append(_np(pkg.nn.MaxUnPool2D(2)(out, mask)))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_batchnorm_eval_uses_the_running_statistics():
    x = _f(4, 3, 2, 2)
    outs = []
    for pkg in (J, TP):
        bn = pkg.nn.BatchNorm2D(3, momentum=0.8)
        for _ in range(2):
            bn(pkg.to_tensor(x))
        bn.eval()
        outs.append(_np(bn(pkg.to_tensor(x * 2))))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


# ---------------------------------------------------------------------------
# nn.utils
# ---------------------------------------------------------------------------

def _utils_run(pkg):
    pkg.seed(4)
    nn = pkg.nn
    lin = nn.Linear(4, 3)
    nn.utils.weight_norm(lin, dim=1)
    x = pkg.to_tensor(_np(np.arange(8, dtype=np.float32).reshape(2, 4)) / 7)
    y1 = lin(x)
    y1.sum().backward()
    names = [n for n, _ in lin.named_parameters()]
    g = [_grad(p) for p in lin.parameters()]
    nn.utils.remove_weight_norm(lin)
    y2 = lin(x)
    conv = nn.Linear(3, 5)
    nn.utils.spectral_norm(conv, n_power_iterations=2)
    y3 = conv(y2)
    vec = nn.utils.parameters_to_vector(list(conv.parameters()))
    nn.utils.vector_to_parameters(vec * 2, list(conv.parameters()))
    y4 = conv(y2)
    lin2 = nn.Linear(3, 2)
    (lin2(x[:, :3]) * 5).sum().backward()
    total = nn.utils.clip_grad_norm_(list(lin2.parameters()), 0.5)
    clipped = [_grad(p) for p in lin2.parameters()]
    nn.utils.clip_grad_value_(list(lin2.parameters()), 0.1)
    return dict(names=names, y1=_np(y1), g=g, y2=_np(y2), y3=_np(y3),
                y4=_np(y4), names2=[n for n, _ in lin.named_parameters()],
                total=_np(total), clipped=clipped,
                valued=[_grad(p) for p in lin2.parameters()],
                rng=pkg.get_rng_state()[0])


def test_utils_match_the_reference():
    r, p = _utils_run(J), _utils_run(TP)
    assert p["names"] == r["names"] and p["names2"] == r["names2"]
    assert p["rng"] == r["rng"]
    for k in ("y1", "y2", "y3", "y4", "total"):
        np.testing.assert_allclose(p[k], r[k], err_msg=k, **TOL)
    for k in ("g", "clipped", "valued"):
        for a, b in zip(r[k], p[k]):
            np.testing.assert_allclose(b, a, err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# the reference's own scenarios, through the port
# ---------------------------------------------------------------------------

#: scenarios that read the JAX package's internals, with the port's
#: counterpart beside them
NN_SKIP = {
    # asserts ``lin.weight.grad.shape == [4, 3]``: a layer's parameter is
    # a torch leaf in the port, whose gradient's shape is a torch.Size
    "test_linear_forward_backward",
}


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_nn.py", NN_SKIP))
def test_nn_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_nn.py", scenario, request)


def test_linear_forward_backward_in_the_port():
    TP.seed(0)
    lin = TP.nn.Linear(4, 3)
    y = lin(TP.randn([2, 4]))
    assert y.shape == [2, 3]
    y.sum().backward()
    assert tuple(lin.weight.grad.shape) == (4, 3)
    assert tuple(lin.bias.grad.shape) == (3,)


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_nn_audit_ops.py"))
def test_audit_ops_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_nn_audit_ops.py", scenario, request)
