"""``paddle_tpu_torch.nn.layers_extra`` against the JAX package on the
CPU: each of its classes forward and backward with the reference's
weights (drawn from one seed, checked equal) on the same inputs, and the
reference's own scenarios (``tests/test_nn_layers_extra.py``) run
through the port. fp32."""

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


R = np.random.RandomState(0)


def f(*shape):
    return R.randn(*shape).astype(np.float32)


def pos(*shape):
    return R.uniform(0.1, 0.9, size=shape).astype(np.float32)


# (id, constructor, inputs, differentiable inputs)
LAYERS = [
    ("MaxPool1D", lambda nn: nn.MaxPool1D(3, 2, 1, ceil_mode=True),
     [f(2, 3, 9)], 1),
    ("AvgPool1D", lambda nn: nn.AvgPool1D(2), [f(2, 3, 8)], 1),
    ("AdaptiveAvgPool1D", lambda nn: nn.AdaptiveAvgPool1D(4), [f(2, 3, 8)], 1),
    ("Pad1D", lambda nn: nn.Pad1D([1, 2], mode="reflect"), [f(2, 3, 5)], 1),
    ("Pad3D", lambda nn: nn.Pad3D(1), [f(1, 2, 3, 3, 3)], 1),
    ("ZeroPad2D", lambda nn: nn.ZeroPad2D([1, 0, 2, 1]), [f(1, 2, 3, 3)], 1),
    ("UpsamplingBilinear2D", lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=2), [f(1, 2, 3, 4)], 1),
    ("GLU", lambda nn: nn.GLU(), [f(3, 8)], 1),
    ("AlphaDropout", lambda nn: nn.AlphaDropout(0.3), [f(6, 8)], 1),
    ("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(3),
     [f(2, 5, 3, 3)], 1),
    ("InstanceNorm1D", lambda nn: nn.InstanceNorm1D(3), [f(2, 3, 7)], 1),
    ("Bilinear", lambda nn: nn.Bilinear(4, 3, 5), [f(2, 4), f(2, 3)], 2),
    ("CosineSimilarity", lambda nn: nn.CosineSimilarity(), [f(3, 5), f(3, 5)],
     2),
    ("PairwiseDistance", lambda nn: nn.PairwiseDistance(), [f(3, 5), f(3, 5)],
     2),
    ("Unfold", lambda nn: nn.Unfold(2), [f(1, 2, 4, 4)], 1),
    ("Fold", lambda nn: nn.Fold((3, 4), 2), [f(1, 8, 6)], 1),
    ("HuberLoss", lambda nn: nn.HuberLoss(delta=0.7), [f(3, 4), f(3, 4)], 2),
    ("MarginRankingLoss", lambda nn: nn.MarginRankingLoss(0.2),
     [f(5), f(5), np.sign(f(5))], 2),
    ("TripletMarginLoss", lambda nn: nn.TripletMarginLoss(swap=True),
     [f(3, 5), f(3, 5), f(3, 5)], 3),
    ("SpectralNorm", lambda nn: nn.SpectralNorm((4, 6), power_iters=3),
     [f(4, 6)], 1),
    ("ChannelShuffle", lambda nn: nn.ChannelShuffle(2), [f(1, 4, 2, 2)], 1),
    ("Softmax2D", lambda nn: nn.Softmax2D(), [f(2, 3, 2, 2)], 1),
    ("ThresholdedReLU", lambda nn: nn.ThresholdedReLU(0.5), [f(3, 6)], 1),
    ("RReLU", lambda nn: nn.RReLU(), [f(3, 6)], 1),
    ("CTCLoss", lambda nn: nn.CTCLoss(), [
        np.log(pos(6, 2, 4) / pos(6, 2, 4).sum(-1, keepdims=True)),
        np.array([[1, 2, 1], [3, 1, 0]], np.int32),
        np.array([6, 5], np.int32), np.array([3, 2], np.int32)], 1),
    ("CosineEmbeddingLoss", lambda nn: nn.CosineEmbeddingLoss(0.1),
     [f(3, 5), f(3, 5), np.sign(f(3))], 2),
    ("GaussianNLLLoss", lambda nn: nn.GaussianNLLLoss(),
     [f(3, 4), f(3, 4), pos(3, 4)], 2),
    ("HingeEmbeddingLoss", lambda nn: nn.HingeEmbeddingLoss(),
     [f(3, 4), np.sign(f(3, 4))], 1),
    ("MultiLabelSoftMarginLoss", lambda nn: nn.MultiLabelSoftMarginLoss(),
     [f(3, 4), pos(3, 4).round()], 1),
    ("MultiMarginLoss", lambda nn: nn.MultiMarginLoss(p=2),
     [f(4, 5), R.randint(0, 5, (4,)).astype(np.int32)], 1),
    ("PoissonNLLLoss", lambda nn: nn.PoissonNLLLoss(full=True),
     [f(3, 4), pos(3, 4) * 3], 1),
    ("SoftMarginLoss", lambda nn: nn.SoftMarginLoss(),
     [f(3, 4), np.sign(f(3, 4))], 1),
    ("AdaptiveLogSoftmaxWithLoss", lambda nn: nn.AdaptiveLogSoftmaxWithLoss(
        8, 12, [4, 8], head_bias=True),
     [f(5, 8), R.randint(0, 12, (5,)).astype(np.int32)], 1),
]


@pytest.mark.parametrize("name,make,inputs,n_grad", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_the_reference(name, make, inputs, n_grad):
    res = []
    for pkg in (J, TP):
        pkg.seed(21)
        layer = make(pkg.nn)
        xs = [pkg.to_tensor(a, stop_gradient=i >= n_grad)
              for i, a in enumerate(inputs)]
        out = layer(*xs)
        outs = list(out) if isinstance(out, tuple) else [out]
        cot = np.asarray(np.random.RandomState(2).randn(*outs[-1].shape),
                         np.float32)
        (outs[-1] * pkg.to_tensor(cot)).sum().backward()
        res.append(([_np(o) for o in outs],
                    [_np(x.grad) for x in xs[:n_grad]]
                    + [_np(p.grad) for p in layer.parameters()],
                    {k: _np(v) for k, v in layer.state_dict().items()},
                    pkg.get_rng_state()[0]))
    (ro, rg, rs, rc), (po, pg, ps, pc) = res
    assert pc == rc and list(ps) == list(rs)
    for k in rs:
        np.testing.assert_allclose(ps[k], rs[k], err_msg=k, **TOL)
    for r, p in zip(ro + rg, po + pg):
        np.testing.assert_allclose(p, r, **TOL)


#: the reference's scenario that writes the cells' weights through
#: ``Parameter._value`` (a layer's parameter is a torch leaf here); the
#: cells against the LSTM are held in test_torch_rnn_decode.py
EXTRA_SKIP = {"TestRNN.test_lstm_shapes_and_scan_matches_cell_loop"}


@pytest.mark.parametrize("scenario", torch_scenarios.scenario_ids(
    "test_nn_layers_extra.py", EXTRA_SKIP))
def test_layers_extra_scenario_through_the_port(scenario, request):
    torch_scenarios.run("test_nn_layers_extra.py", scenario, request)


def test_lstm_matches_its_cell_loop_in_the_port():
    TP.seed(0)
    lstm = TP.nn.LSTM(4, 6)
    cell = TP.nn.LSTMCell(4, 6)
    for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        getattr(cell, n).set_value(getattr(lstm, f"{n}_l0"))
    x = TP.to_tensor(R.randn(2, 5, 4).astype(np.float32))
    out, (h, c) = lstm(x)
    st = None
    for t in range(5):
        y, st = cell(x[:, t], st)
    np.testing.assert_allclose(_np(y), _np(out)[:, -1], rtol=1e-5)
    np.testing.assert_allclose(_np(h)[0], _np(out)[:, -1], rtol=1e-5)
