"""The port's ``core.extra_ops`` against the JAX package's: the scenarios of
``tests/test_extra_ops.py`` run through both packages, and their results
compared. The port runs on the CPU."""

import numpy as np
import pytest

import paddle_tpu as JP
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


@pytest.fixture(params=["ref", "port"])
def paddle(request):
    return JP if request.param == "ref" else TP


def _np(t):
    return np.asarray(t.numpy())


def test_predicates_and_rank(paddle):
    t = paddle.to_tensor(np.ones((2, 3), np.float32))
    assert paddle.is_floating_point(t) and not paddle.is_complex(t)
    assert int(paddle.rank(t)) == 2
    assert not bool(paddle.is_empty(t))
    assert paddle.tolist(t) == [[1.0, 1.0, 1.0]] * 2
    assert paddle.broadcast_shape([2, 1, 3], [4, 3]) == [2, 4, 3]


def test_clone_differentiable(paddle):
    t = paddle.to_tensor(np.ones((3,), np.float32))
    t.stop_gradient = False
    c = paddle.clone(t)
    (c * 2).sum().backward()
    np.testing.assert_allclose(_np(t.grad), [2, 2, 2])


def test_view_and_unflatten_splits(paddle):
    t = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    v = paddle.view(t, [2, 6])
    assert tuple(v.shape) == (2, 6)
    u = paddle.unflatten(t, axis=1, shape=(2, 2))
    assert tuple(u.shape) == (3, 2, 2)
    parts = paddle.vsplit(t, 3)
    assert len(parts) == 3 and tuple(parts[0].shape) == (1, 4)
    hs = paddle.hsplit(t, 2)
    assert len(hs) == 2 and tuple(hs[0].shape) == (3, 2)
    us = paddle.unstack(t, axis=0)
    assert len(us) == 3 and tuple(us[0].shape) == (4,)
    d = paddle.dsplit(paddle.reshape(t, [1, 3, 4]), 2)
    assert tuple(d[1].shape) == (1, 3, 2)


def test_broadcast_tensors_and_slice(paddle):
    a = paddle.to_tensor(np.ones((1, 3), np.float32))
    b = paddle.to_tensor(np.ones((2, 1), np.float32))
    oa, ob = paddle.broadcast_tensors([a, b])
    assert tuple(oa.shape) == (2, 3) == tuple(ob.shape)
    t = paddle.to_tensor(np.arange(24, dtype=np.float32).reshape(4, 6))
    s = paddle.slice(t, axes=[0, 1], starts=[1, 2], ends=[3, 5])
    np.testing.assert_allclose(_np(s), np.arange(24).reshape(4, 6)[1:3, 2:5])
    s = paddle.slice(t, axes=[1], starts=[-2], ends=[100])
    np.testing.assert_allclose(_np(s), np.arange(24).reshape(4, 6)[:, 4:])


def test_unique_consecutive(paddle):
    t = paddle.to_tensor(np.asarray([1, 1, 2, 2, 2, 3, 1], np.int32))
    out, inv, cnt = paddle.unique_consecutive(t, return_inverse=True,
                                              return_counts=True)
    np.testing.assert_allclose(_np(out), [1, 2, 3, 1])
    np.testing.assert_allclose(_np(inv), [0, 0, 1, 1, 1, 2, 3])
    np.testing.assert_allclose(_np(cnt), [2, 3, 1, 1])
    assert _np(inv).dtype == _np(cnt).dtype == np.int32


def test_shard_index(paddle):
    idx = paddle.to_tensor(np.asarray([0, 5, 9, 12, 19], np.int32))
    out = paddle.shard_index(idx, index_num=20, nshards=2, shard_id=0)
    np.testing.assert_allclose(_np(out), [0, 5, 9, -1, -1])
    out1 = paddle.shard_index(idx, index_num=20, nshards=2, shard_id=1)
    np.testing.assert_allclose(_np(out1), [-1, -1, -1, 2, 9])


def test_inverse(paddle):
    a = np.asarray([[2.0, 0.0], [1.0, 3.0]], np.float32)
    inv = _np(paddle.inverse(paddle.to_tensor(a)))
    np.testing.assert_allclose(inv @ a, np.eye(2), atol=1e-5)


def test_poisson_draws_from_the_key_stream():
    """The port's Poisson draw is seeded from the framework key stream
    (same seed, same draw) with the right mean; its bits are not the
    JAX package's (a stated difference: torch's sampler)."""
    TP.seed(0)
    lam = TP.to_tensor(np.full((2000,), 4.0, np.float32))
    s = _np(TP.poisson(lam))
    TP.seed(0)
    np.testing.assert_array_equal(_np(TP.poisson(lam)), s)
    assert abs(s.mean() - 4.0) < 0.2 and s.min() >= 0


def test_hstack_list_form_and_unique_consecutive_axis(paddle):
    a = paddle.to_tensor(np.ones((3, 2), np.float32))
    b = paddle.to_tensor(np.zeros((3, 4), np.float32))
    out = paddle.hstack([a, b])
    assert tuple(out.shape) == (3, 6)
    t = paddle.to_tensor(np.asarray([[1, 1, 2], [3, 3, 4]], np.int32))
    out = paddle.unique_consecutive(t, axis=1)
    np.testing.assert_allclose(_np(out), [[1, 2], [3, 4]])


def test_stacks(paddle):
    a = paddle.to_tensor(np.asarray([1.0, 2.0], np.float32))
    b = paddle.to_tensor(np.asarray([3.0, 4.0], np.float32))
    np.testing.assert_array_equal(_np(paddle.vstack([a, b])), [[1, 2], [3, 4]])
    np.testing.assert_array_equal(_np(paddle.row_stack([a, b])),
                                  [[1, 2], [3, 4]])
    np.testing.assert_array_equal(_np(paddle.column_stack([a, b])),
                                  [[1, 3], [2, 4]])
    assert tuple(paddle.dstack([a, b]).shape) == (1, 2, 2)


def test_atleast(paddle):
    s = paddle.to_tensor(np.float32(5.0))
    assert tuple(paddle.atleast_1d(s).shape) == (1,)
    assert tuple(paddle.atleast_2d(s).shape) == (1, 1)
    assert tuple(paddle.atleast_3d(s).shape) == (1, 1, 1)
    outs = paddle.atleast_2d(s, s)
    assert isinstance(outs, list) and len(outs) == 2


def test_tensor_split_matches_numpy(paddle):
    x = np.arange(11, dtype=np.float32)
    got = [_np(t) for t in paddle.tensor_split(paddle.to_tensor(x), 3)]
    for g, w in zip(got, np.array_split(x, 3)):
        np.testing.assert_array_equal(g, w)
    got = [_np(t) for t in paddle.tensor_split(paddle.to_tensor(x), [2, 7])]
    for g, w in zip(got, np.split(x, [2, 7])):
        np.testing.assert_array_equal(g, w)


def test_mode(paddle):
    x = paddle.to_tensor(np.asarray([[2, 2, 3, 1], [9, 9, 9, 1]], np.int32))
    vals, idx = paddle.mode(x)
    np.testing.assert_array_equal(_np(vals), [2, 9])
    np.testing.assert_array_equal(_np(idx), [1, 2])
    vals, idx = paddle.mode(x, axis=0, keepdim=True)
    assert tuple(vals.shape) == (1, 4)


def test_masked_scatter(paddle):
    x = paddle.to_tensor(np.zeros((2, 3), np.float32))
    mask = paddle.to_tensor(np.asarray([[1, 0, 1], [0, 1, 0]], bool))
    val = paddle.to_tensor(np.asarray([5.0, 6.0, 7.0, 8.0], np.float32))
    got = _np(paddle.masked_scatter(x, mask, val))
    np.testing.assert_array_equal(got, [[5, 0, 6], [0, 7, 0]])


def test_scatter_views(paddle):
    x = paddle.to_tensor(np.zeros((3, 4), np.float32))
    d = paddle.to_tensor(np.asarray([1.0, 2.0, 3.0], np.float32))
    got = _np(paddle.diagonal_scatter(x, d))
    np.testing.assert_array_equal(np.diag(got), [1, 2, 3])
    off = _np(paddle.diagonal_scatter(
        x, paddle.to_tensor(np.asarray([9.0, 9.0, 9.0], np.float32)),
        offset=1))
    np.testing.assert_array_equal([off[0, 1], off[1, 2], off[2, 3]],
                                  [9, 9, 9])
    row = paddle.to_tensor(np.asarray([7.0, 7.0, 7.0, 7.0], np.float32))
    got = _np(paddle.select_scatter(x, row, 0, 1))
    np.testing.assert_array_equal(got[1], [7, 7, 7, 7])
    blk = paddle.to_tensor(np.ones((3, 2), np.float32))
    got = _np(paddle.slice_scatter(x, blk, axes=[1], starts=[1], ends=[3],
                                   strides=[1]))
    np.testing.assert_array_equal(got[:, 1:3], np.ones((3, 2)))


@pytest.mark.parametrize("kw", [dict(bins=5), dict(bins=[3, 4]),
                                dict(bins=4, ranges=[-1, 1, -2, 2],
                                     density=True)])
def test_histogramdd(paddle, kw):
    x = np.random.RandomState(0).randn(50, 2).astype(np.float32)
    hist, edges = paddle.histogramdd(paddle.to_tensor(x), **kw)
    np_kw = dict(kw)
    if "ranges" in np_kw:
        r = np_kw.pop("ranges")
        np_kw["range"] = [(r[0], r[1]), (r[2], r[3])]
    want, wedges = np.histogramdd(x, **np_kw)
    np.testing.assert_allclose(_np(hist), want, rtol=1e-5)
    assert len(edges) == 2
    for e, w in zip(edges, wedges):
        np.testing.assert_allclose(_np(e), w, rtol=1e-6)


_SWEEP4 = {
    "frac": lambda p, x: p.frac(x),
    "gammaln": lambda p, x: p.gammaln(p.abs(x) + 0.5),
    "isin": lambda p, x: p.isin(p.round(x), p.to_tensor([0.0, 1.0])),
    "clip_": lambda p, x: p.clip_(x * 1.0, -0.5, 0.5),
    "index_put": lambda p, x: p.index_put(
        x, [p.to_tensor([0, 2])], p.to_tensor([9.0]), accumulate=False),
    "index_put_add": lambda p, x: p.index_put(
        x, [p.to_tensor([0, 0]), p.to_tensor([1, 1])], p.to_tensor([1.0]),
        accumulate=True),
    "unfold": lambda p, x: p.unfold(x, 1, 3, 2),
}


@pytest.mark.parametrize("name", sorted(_SWEEP4))
def test_sweep4_ops_match_the_reference(name):
    x_np = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    ref = _np(_SWEEP4[name](JP, JP.to_tensor(x_np)))
    got = _np(_SWEEP4[name](TP, TP.to_tensor(x_np)))
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_geometric_matches_the_reference_draw():
    got = []
    for p in (JP, TP):
        p.seed(7)
        t = p.to_tensor(np.zeros((64,), np.float32))
        got.append(_np(p.geometric_(t, 0.3)))
    np.testing.assert_array_equal(got[1], got[0])
    assert got[1].min() >= 1
