"""``paddle_tpu_torch.vision.ops`` (``box_iou``, ``nms``, ``roi_align``,
``yolo_box``, ``box_coder``) and PP-YOLOE's ``predict_with_nms`` against
the JAX package's on the CPU, on the same numpy inputs (the cases of
``tests/test_vision_ops.py``). NMS keeps are compared exactly; fp32
arithmetic at the reference's order within ``OUT``."""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as _place
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch.vision import ops as TV
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def _cpu_place():
    """The CPU is this file's place; the next file's is left as found."""
    prev = _place._current_place[0]
    tp.set_device("cpu")
    yield
    _place._current_place[0] = prev

OUT = dict(rtol=1e-5, atol=1e-5)


def _np(a):
    v = getattr(a, "_value", a)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _rand_boxes(rng, n, size=100.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * 30 + 2
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    """``fn`` of each package on Tensors of the same arrays."""
    j = fn_j(*(None if a is None else jp.to_tensor(a) for a in arrays), **kw)
    t = fn_t(*(None if a is None else tp.to_tensor(a) for a in arrays), **kw)
    return j, t


@pytest.mark.parametrize("thr", [0.1, 0.3, 0.6])
def test_nms_matches_jax(thr):
    rng = np.random.RandomState(0)
    boxes = _rand_boxes(rng, 60)
    scores = rng.rand(60).astype(np.float32)
    j = JV.nms(jp.to_tensor(boxes), thr, jp.to_tensor(scores))
    t = TV.nms(tp.to_tensor(boxes), thr, tp.to_tensor(scores))
    assert _np(t).dtype == _np(j).dtype
    np.testing.assert_array_equal(_np(t), _np(j))


def test_nms_without_scores_keeps_document_order():
    boxes = _rand_boxes(np.random.RandomState(8), 20)
    np.testing.assert_array_equal(
        _np(TV.nms(torch.from_numpy(boxes), 0.2)),
        _np(JV.nms(jp.to_tensor(boxes), 0.2)))


def test_nms_ties_keep_the_index_order():
    """Equal scores sort stably (lower index first), as ``jnp.argsort``."""
    boxes = _rand_boxes(np.random.RandomState(9), 12)
    scores = np.repeat(np.float32([0.5, 0.7, 0.2]), 4)
    j = JV.nms(jp.to_tensor(boxes), 0.3, jp.to_tensor(scores))
    t = TV.nms(tp.to_tensor(boxes), 0.3, tp.to_tensor(scores))
    np.testing.assert_array_equal(_np(t), _np(j))


def test_categorical_nms_is_per_class_and_top_k():
    rng = np.random.RandomState(1)
    boxes = np.concatenate([np.tile(_rand_boxes(rng, 1), (2, 1)),
                            _rand_boxes(rng, 30)])
    scores = rng.rand(32).astype(np.float32)
    scores[:2] = [0.99, 0.98]
    cats = rng.randint(0, 3, 32).astype(np.int32)
    cats[:2] = [0, 1]
    for top_k in (None, 5):
        j = JV.nms(jp.to_tensor(boxes), 0.5, jp.to_tensor(scores),
                   jp.to_tensor(cats), categories=[0, 1, 2], top_k=top_k)
        t = TV.nms(tp.to_tensor(boxes), 0.5, tp.to_tensor(scores),
                   tp.to_tensor(cats), categories=[0, 1, 2], top_k=top_k)
        np.testing.assert_array_equal(_np(t), _np(j))
    assert {0, 1} <= set(_np(t).tolist()) and len(_np(t)) == 5
    with pytest.raises(ValueError, match="requires scores"):
        TV.nms(tp.to_tensor(boxes), 0.5, None, tp.to_tensor(cats))


def test_box_iou_matches_jax():
    rng = np.random.RandomState(3)
    a, b = _rand_boxes(rng, 5), _rand_boxes(rng, 7)
    a[0] = [5, 5, 5, 9]                              # zero area
    j, t = _both(JV.box_iou, TV.box_iou, a, b)
    assert tuple(t.shape) == (5, 7)
    np.testing.assert_allclose(_np(t), _np(j), **OUT)
    # torch tensors in, a torch tensor out
    raw = TV.box_iou(torch.from_numpy(a), torch.from_numpy(a))
    assert isinstance(raw, torch.Tensor)
    np.testing.assert_allclose(np.diag(raw.numpy())[1:], 1.0, rtol=1e-6)


@pytest.mark.parametrize("var", [None, "rows", "one"])
def test_box_coder_encode_decode_match_jax(var):
    rng = np.random.RandomState(4)
    priors, targets = _rand_boxes(rng, 6), _rand_boxes(rng, 6)
    pv = {None: None, "rows": rng.rand(6, 4).astype(np.float32) + 0.5,
          "one": np.float32([0.1, 0.1, 0.2, 0.2])}[var]
    for norm in (True, False):
        j, t = _both(JV.box_coder, TV.box_coder, priors, pv, targets,
                     box_normalized=norm)
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5)
        deltas = rng.randn(6, 6, 4).astype(np.float32) * 0.1
        for axis in (0, 1):
            j, t = _both(JV.box_coder, TV.box_coder, priors, pv, deltas,
                         code_type="decode_center_size",
                         box_normalized=norm, axis=axis)
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("ratio", [-1, 3])
def test_roi_align_matches_jax(aligned, ratio):
    """Two images, RoIs inside, on the edge and past it, the default
    2×2 grid and an explicit sampling ratio."""
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 3, 9, 11).astype(np.float32)
    rois = np.asarray([[0, 0, 7, 7], [1.5, 1, 6, 6.5], [0, 0, 10, 8],
                       [-2, 3, 14, 12], [4, 4, 4.2, 4.1]], np.float32)
    num = np.asarray([3, 2], np.int32)
    for scale, size in ((1.0, 4), (0.5, (2, 3))):
        j, t = _both(JV.roi_align, TV.roi_align, feat, rois, num,
                     output_size=size, spatial_scale=scale,
                     sampling_ratio=ratio, aligned=aligned)
        np.testing.assert_allclose(_np(t), _np(j), **OUT)
    a = _np(t)
    assert not np.allclose(a[0], a[3])


@pytest.mark.parametrize("clip", [True, False])
def test_yolo_box_matches_jax(clip):
    rng = np.random.RandomState(6)
    A, C, H, W = 3, 4, 5, 5
    x = rng.randn(2, A * (5 + C), H, W).astype(np.float32)
    img = np.asarray([[320, 320], [416, 320]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=C,
              downsample_ratio=32, clip_bbox=clip, scale_x_y=1.05,
              conf_thresh=0.3)
    (jb, js), (tb, ts) = _both(JV.yolo_box, TV.yolo_box, x, img, **kw)
    assert tuple(tb.shape) == (2, A * H * W, 4)
    np.testing.assert_allclose(_np(tb), _np(jb), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(ts), _np(js), **OUT)


def test_ppyoloe_predict_with_nms_end_to_end():
    """The serving tail (``tests/test_vision_ops.py``'s last case):
    predict, then class-aware NMS, with the reference's weights carried
    by ``set_state_dict``; the kept boxes, scores and labels agree."""
    from paddle_tpu.vision.models.ppyoloe import PPYOLOE as JP
    from paddle_tpu_torch.vision.models.ppyoloe import PPYOLOE as TP
    jp.seed(0)
    jnet = JP(num_classes=4, width_mult=0.25, depth_mult=0.33)
    jnet.eval()
    net = TP(num_classes=4, width_mult=0.25, depth_mult=0.33)
    missing, unexpected = net.set_state_dict(
        {k: _np(v) for k, v in jnet.state_dict().items()})
    assert not missing and not unexpected
    net.eval()
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    kw = dict(score_threshold=0.0, top_k=20, nms_threshold=0.5,
              keep_top_k=10)
    want = jnet.predict_with_nms(jp.to_tensor(x), **kw)
    got = net.predict_with_nms(tp.to_tensor(x), **kw)
    assert len(got) == 2
    for (b, s, l), (jb, js, jl) in zip(got, want):
        assert b.shape[0] <= 10 and b.shape[1] == 4
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-3)
        if s.size > 1:
            assert (np.diff(s) <= 1e-6).all()
