"""The ``nn.Layer`` base of the PyTorch port (``paddle_tpu_torch.nn.layer``)
against the JAX package's ``paddle_tpu.nn.layer`` on the CPU: the
reference's own layer tests through both packages, every ported model's
parameter and state-dict names in the reference's order (GPT's fused
stack lists its parameters layer by layer, as the reference registers
them), and ``set_state_dict`` of the reference's state giving the
reference's logits. Layers are Paddle-style (``nn.Linear(4, 8)``) on
the current place, the CPU here."""

import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as TP
from paddle_tpu import nn as jnn
from paddle_tpu.models import ernie as JE
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# fp32 logits of two stacks summing in other orders (test_torch_gpt's)
LOGITS = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(p):
    return np.asarray(p._value if hasattr(p, "_value") else p, np.float32)


def _copy_linear(dst, src):
    with torch.no_grad():
        for n, p in dst.named_parameters():
            p.copy_(torch.from_numpy(_np(dict(src.named_parameters())[n])))


# ---------------------------------------------------------------------------
# the reference's layer tests (tests/test_nn.py), through both packages
# ---------------------------------------------------------------------------

def _net(nn, F):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.fc2 = nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))
    return Net()


def test_layer_registry_and_state_dict():
    paddle.seed(0)
    jnet, tnet = _net(jnn, JF), _net(tnn, TF)
    names = ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    assert [n for n, _ in jnet.named_parameters()] == names
    assert [n for n, _ in tnet.named_parameters()] == names
    assert list(tnet.state_dict()) == list(jnet.state_dict()) == names
    # the reference's state into a fresh port net: its outputs
    tnet2 = _net(tnn, TF)
    missing, unexpected = tnet2.set_state_dict(jnet.state_dict())
    assert missing == [] and unexpected == []
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    want = jnet(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(tnet2(TP.to_tensor(x)).numpy(), want,
                               **LOGITS)
    # and the port's own round trip, as the reference test does
    tnet3 = _net(tnn, TF)
    tnet3.set_state_dict(tnet2.state_dict())
    np.testing.assert_allclose(tnet3(TP.to_tensor(x)).numpy(),
                               tnet2(TP.to_tensor(x)).numpy(), rtol=1e-6)


def test_sequential_and_layerlist():
    for nn, P in ((jnn, paddle), (tnn, TP)):
        seq = nn.Sequential(nn.Linear(4, 4), nn.ReLU(), nn.Linear(4, 2))
        x = P.randn([2, 4])
        assert seq(x).shape == [2, 2]
        ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
        assert len(ll) == 3
        assert len(list(ll.parameters())) == 6


def test_layer_gradients_flow_through_tensor_ops():
    """A Tensor op on a layer's torch parameters carries gradients: one
    SGD-free step's gradients equal the reference's."""
    paddle.seed(1)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tnet = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    for i in (0, 2):
        _copy_linear(tnet[i], jnet[i])
    x = np.random.RandomState(2).randn(8, 4).astype(np.float32)
    jloss = (jnet(paddle.to_tensor(x)) ** 2).mean()
    tloss = (tnet(TP.to_tensor(x)) ** 2).mean()
    assert not tloss.stop_gradient
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for (n, tp), (_, jp) in zip(tnet.named_parameters(),
                                jnet.named_parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_containers_hooks_and_buffers():
    """``LayerList``/``ParameterList`` indexing and insertion,
    ``sublayers``, forward pre/post hooks and their removal, a
    non-persistable buffer left out of ``state_dict``, and ``train`` /
    ``eval`` reaching every sublayer, as in the reference."""
    for nn in (jnn, tnn):
        ll = nn.LayerList([nn.Linear(2, 2), nn.Linear(2, 3)])
        ll.insert(1, nn.ReLU())
        assert [type(m).__name__ for m in ll] == ["Linear", "ReLU", "Linear"]
        assert [n for n, _ in ll.named_parameters()] == [
            "0.weight", "0.bias", "2.weight", "2.bias"]
        seq = nn.Sequential(collections.OrderedDict(
            [("a", nn.Linear(2, 2)), ("b", nn.ReLU())]))
        assert [n for n, _ in seq.named_sublayers()] == ["a", "b"]
        assert len(seq.sublayers(include_self=True)) == 3
        calls = []
        pre = seq.register_forward_pre_hook(
            lambda layer, inputs: calls.append("pre"))
        post = seq.register_forward_post_hook(
            lambda layer, inputs, out: out * 0)
        x = (paddle if nn is jnn else TP).ones([1, 2])
        assert float(seq(x).sum()) == 0.0 and calls == ["pre"]
        pre.remove()
        post.remove()
        seq(x)
        assert calls == ["pre"]
        seq.register_buffer("keep", (paddle if nn is jnn else TP).ones([2]))
        seq.register_buffer("drop", (paddle if nn is jnn else TP).ones([2]),
                            persistable=False)
        assert list(seq.state_dict()) == ["a.weight", "a.bias", "keep"]
        seq.eval()
        assert not any(m.training for m in seq.sublayers(include_self=True))
        seq.train()
        assert all(m.training for m in seq.sublayers(include_self=True))


def test_set_state_dict_reports_and_refuses():
    """Missing and unexpected keys come back; a wrong shape raises; the
    copy goes into the same leaf (an optimizer's handle stays valid) in
    the target's dtype."""
    net = tnn.Linear(3, 2)
    w = net.weight
    missing, unexpected = net.set_state_dict(
        {"weight": np.ones((3, 2), np.float64), "extra": np.zeros(1)})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert net.weight is w and w.dtype == torch.float32
    assert torch.equal(w, torch.ones(3, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"bias": np.zeros(3, np.float32)})


# ---------------------------------------------------------------------------
# every ported model: names and order are the reference's
# ---------------------------------------------------------------------------

def _gpt():
    return (JG.GPTForCausalLM(JG.gpt_tiny()),
            TG.GPTForCausalLM(TG.gpt_tiny(), device="cpu"))


def _ernie(cls):
    def make():
        return (getattr(JE, cls)(JE.ernie_tiny()),
                getattr(TE, cls)(TE.ernie_tiny(), device="cpu"))
    return make


def _llama(tie):
    def make():
        cfg = dict(num_hidden_layers=2, tie_word_embeddings=tie)
        return (JL.LlamaForCausalLM(JL.llama_tiny(**cfg)),
                TL.LlamaForCausalLM(TL.llama_tiny(**cfg), device="cpu"))
    return make


MODELS = {"gpt": _gpt, "ernie_mlm": _ernie("ErnieForMaskedLM"),
          "ernie_cls": _ernie("ErnieForSequenceClassification"),
          "llama": _llama(False), "llama_tied": _llama(True)}


def test_gpt_parameter_order_is_the_references():
    """The fused stack's per-layer weights listed layer by layer
    (``ln_scales.0, ln_biases.0, qkv_weights.0, ...``), not kind by
    kind: an optimizer state saved under other names binds by this
    order."""
    paddle.seed(0)
    jm, tm = _gpt()
    want = [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_parameters()] == want
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.gpt.decoder.named_parameters(
        include_sublayers=False)] == [n for n, _ in
                                     jm.gpt.decoder.named_parameters()]
    assert [tuple(p.shape) for p in tm.parameters()] == [
        tuple(p.shape) for p in jm.parameters()]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_names_and_order_are_the_references(model):
    paddle.seed(0)
    jm, tm = MODELS[model]()
    assert [n for n, _ in tm.named_parameters()] == [
        n for n, _ in jm.named_parameters()]
    assert list(tm.state_dict()) == list(jm.state_dict())
    # torch's own state dict holds the same names
    assert set(tm.state_dict(keep_vars=True)) == set(jm.state_dict())


@pytest.mark.parametrize("model", ["gpt", "ernie_mlm", "llama"])
def test_set_state_dict_of_the_references_state_gives_its_logits(model):
    paddle.seed(4)
    jm, tm = MODELS[model]()
    missing, unexpected = tm.set_state_dict(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []
    ids = np.random.RandomState(5).randint(0, 128, (2, 9)).astype(np.int32)
    want = jm(paddle.to_tensor(ids))
    want = np.asarray((want[0] if isinstance(want, tuple) else want)._value)
    got = tm(torch.from_numpy(ids))
    got = (got[0] if isinstance(got, tuple) else got).detach().numpy()
    np.testing.assert_allclose(got, want, **LOGITS)
