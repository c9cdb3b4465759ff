"""PP-YOLOE (``paddle_tpu_torch.vision.models.ppyoloe``) against the JAX
package's on the CPU: the forward over the static anchor set, the
detection loss and its gradients, ``predict``'s top-k (ties to the lower
index, as ``lax.top_k``), ``predict_bucketed``, ``pad_ground_truth`` and
a compiled training step. The port's weights are the reference's,
carried by ``set_state_dict``. fp32; bound ``OUT`` for outputs. The loss
and gradients are taken in training mode, whose BatchNorms over small
maps magnify the packages' fp32 convolution sums: the gradients are held
by their relative L2 error (``GRAD_L2``)."""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as _place
from paddle_tpu.vision.models import ppyoloe as JP
from paddle_tpu_torch.vision.models import ppyoloe as TP
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def _cpu_place():
    """The CPU is this file's place; the next file's is left as found."""
    prev = _place._current_place[0]
    tp.set_device("cpu")
    yield
    _place._current_place[0] = prev

OUT = dict(rtol=1e-4, atol=1e-4)
#: measured at most 3e-4 (the stem's first convolution); a wrong term or
#: a missed positive anchor moves a gradient by far more
GRAD_L2 = 2e-3


def _np(a):
    v = getattr(a, "_value", a)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _pair():
    jp.seed(0)
    jnet = JP.PPYOLOE(num_classes=4, width_mult=0.25, depth_mult=0.33)
    net = TP.PPYOLOE(num_classes=4, width_mult=0.25, depth_mult=0.33)
    missing, unexpected = net.set_state_dict(
        {k: _np(v) for k, v in jnet.state_dict().items()})
    assert not missing and not unexpected
    return jnet, net


def _x(b=2, seed=0):
    return np.random.RandomState(seed).randn(b, 3, 64, 64).astype(np.float32)


GT_BOXES = np.asarray([[[8, 8, 40, 40], [24, 24, 60, 60]],
                       [[4, 4, 32, 32], [0, 0, 0, 0]]], np.float32)
GT_LABELS = np.asarray([[1, 3], [2, -1]], np.int32)


def test_forward_static_anchor_set_matches_jax():
    jnet, net = _pair()
    jnet.eval()
    net.eval()
    x = _x()
    scores, boxes = net(tp.to_tensor(x))
    js, jb = jnet(jp.to_tensor(x))
    assert tuple(scores.shape) == (2, 84, 4)         # 64 + 16 + 4 anchors
    np.testing.assert_allclose(_np(scores), _np(js), **OUT)
    np.testing.assert_allclose(_np(boxes), _np(jb), rtol=1e-4, atol=2e-3)
    b = _np(boxes)
    assert (b[..., 2] >= b[..., 0]).all() and (b[..., 3] >= b[..., 1]).all()


def test_compute_loss_and_gradients_match_jax():
    jnet, net = _pair()
    x = _x(seed=2)
    out = []
    for pkg, m in ((jp, jnet), (tp, net)):
        loss = m.compute_loss(pkg.to_tensor(x), pkg.to_tensor(GT_BOXES),
                              pkg.to_tensor(GT_LABELS))
        loss.backward()
        out.append((float(_np(loss)),
                    {n: _np(p.grad) for n, p in m.named_parameters()}))
    (jl, jg), (tl, tg) = out
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jg.keys() == tg.keys()
    for k in jg:
        rel = np.linalg.norm(tg[k] - jg[k]) / (np.linalg.norm(jg[k]) + 1e-12)
        assert rel < GRAD_L2, (k, rel)
    # a host array beside torch tensors is made one on their device
    raw = net.compute_loss(torch.from_numpy(x), GT_BOXES, GT_LABELS)
    assert isinstance(raw, torch.Tensor)


def test_predict_topk_matches_jax():
    jnet, net = _pair()
    jnet.eval()
    net.eval()
    x = _x(1, seed=1)
    got = net.predict(tp.to_tensor(x), score_threshold=0.3, top_k=10)
    want = jnet.predict(jp.to_tensor(x), score_threshold=0.3, top_k=10)
    assert tuple(got[1].shape) == (1, 10, 4)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **OUT)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    assert (np.diff(_np(got[0])[0]) <= 1e-6).all()


def test_predict_topk_breaks_ties_to_the_lower_index():
    """Scores with many equal best values: the selected anchors, boxes
    and labels are ``lax.top_k``'s (the lower index first)."""
    jnet, net = _pair()
    rng = np.random.RandomState(3)
    scores = np.round(rng.rand(2, 84, 4) * 4) / 4        # many ties
    scores = scores.astype(np.float32)
    boxes = rng.rand(2, 84, 4).astype(np.float32) * 64
    jnet.forward = lambda images: (jp.to_tensor(scores), jp.to_tensor(boxes))
    net.forward = lambda images: (tp.to_tensor(scores), tp.to_tensor(boxes))
    got = net.predict(None, score_threshold=0.5, top_k=30)
    want = jnet.predict(None, score_threshold=0.5, top_k=30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_predict_bucketed_and_pad_ground_truth_match_jax():
    jnet, net = _pair()
    jnet.eval()
    net.eval()
    full = _x(4, seed=1)
    for b in (1, 3):
        got = net.predict_bucketed(tp.to_tensor(full[:b]), top_k=10,
                                   batch_buckets=(2, 4))
        want = jnet.predict_bucketed(jp.to_tensor(full[:b]), top_k=10,
                                     batch_buckets=(2, 4))
        assert got[0].shape[0] == b
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), **OUT)
        np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    direct = net.predict(tp.to_tensor(full[:3]), top_k=10)
    np.testing.assert_allclose(_np(got[0]), _np(direct[0]), rtol=1e-5,
                               atol=1e-6)
    rng = np.random.RandomState(1)
    boxes = [rng.rand(3, 4) * 32, rng.rand(7, 4) * 32, np.zeros((0, 4))]
    labels = [np.arange(3), np.arange(7), np.zeros((0,))]
    tb, tl = TP.pad_ground_truth(boxes, labels, buckets=(8, 16))
    jb, jl = JP.pad_ground_truth(boxes, labels, buckets=(8, 16))
    assert tuple(tb.shape) == (3, 8, 4)
    np.testing.assert_array_equal(_np(tb), _np(jb))
    np.testing.assert_array_equal(_np(tl), _np(jl))


def test_compiled_train_step_matches_jax_and_reduces_loss():
    """``jit.TrainStep`` over ``compute_loss`` with AdamW (the
    reference test's loop): the first steps' losses are the
    reference's, and eight steps reduce it."""
    jnet, net = _pair()
    x = _x(seed=2)
    runs = []
    for pkg, m in ((jp, jnet), (tp, net)):
        opt = pkg.optimizer.AdamW(learning_rate=2e-3,
                                  parameters=m.parameters())
        step = pkg.jit.TrainStep(
            m, lambda model, img, gb, gl: model.compute_loss(img, gb, gl),
            opt)
        args = [pkg.to_tensor(a) for a in (x, GT_BOXES, GT_LABELS)]
        runs.append([float(_np(step(*args))) for _ in range(8)])
    (jl, tl) = runs
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=1e-3)
