"""The Paddle-shaped Tensor surface of the port (``paddle_tpu_torch``'s top
level over ``core.tensor``, ``core.math_ops`` and ``creation``) against
the JAX package's: the scenarios of ``tests/test_tensor.py`` run through
both packages and their results compared, then the port's dtype
canonicalisation (the reference's x64-off result dtypes), places,
``__setitem__`` under grad and gradient hooks. The port runs on the CPU
(``set_device("cpu")``); the fixture restores the previous place."""

import numpy as np
import pytest
import torch

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


def _dtype_name(t):
    return str(t.dtype).rpartition(".")[2]


def _both(fn):
    """fn(paddle) through both packages, results as numpy (or lists of)."""
    out = []
    for pkg in (JP, TP):
        r = fn(pkg)
        out.append([_np(x) for x in r] if isinstance(r, (list, tuple))
                   else _np(r))
    return out


# ---------------------------------------------------------------------------
# the scenarios of tests/test_tensor.py, in both packages
# ---------------------------------------------------------------------------

def test_to_tensor_roundtrip(paddle):
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert x.shape == [2, 2]
    np.testing.assert_allclose(x.numpy(), [[1, 2], [3, 4]])
    assert _dtype_name(x) == "float32"


def test_arithmetic(paddle):
    a = paddle.to_tensor([1.0, 2.0, 3.0])
    b = paddle.to_tensor([4.0, 5.0, 6.0])
    np.testing.assert_allclose((a + b).numpy(), [5, 7, 9])
    np.testing.assert_allclose((a * b).numpy(), [4, 10, 18])
    np.testing.assert_allclose((b - a).numpy(), [3, 3, 3])
    np.testing.assert_allclose((b / a).numpy(), [4, 2.5, 2], rtol=1e-6)
    np.testing.assert_allclose((a ** 2).numpy(), [1, 4, 9])
    np.testing.assert_allclose((2 + a).numpy(), [3, 4, 5])
    np.testing.assert_allclose((-a).numpy(), [-1, -2, -3])
    np.testing.assert_allclose((2 ** a).numpy(), [2, 4, 8])
    np.testing.assert_allclose((1 - a).numpy(), [0, -1, -2])


def test_matmul(paddle):
    a = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_allclose((a @ b).numpy(), a.numpy() @ b.numpy())
    c = paddle.matmul(a, a, transpose_y=True)
    np.testing.assert_allclose(c.numpy(), a.numpy() @ a.numpy().T)


def test_reductions(paddle):
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_allclose(x.sum().numpy(), 66)
    np.testing.assert_allclose(x.mean(axis=0).numpy(), x.numpy().mean(0))
    np.testing.assert_allclose(x.max(axis=1, keepdim=True).numpy(),
                               x.numpy().max(1, keepdims=True))
    np.testing.assert_allclose(paddle.std(x).numpy(), x.numpy().std(ddof=1),
                               rtol=1e-6)


def test_manipulation(paddle):
    x = paddle.arange(24, dtype="float32").reshape([2, 3, 4])
    assert x.transpose([1, 0, 2]).shape == [3, 2, 4]
    assert paddle.concat([x, x], axis=1).shape == [2, 6, 4]
    assert paddle.stack([x, x]).shape == [2, 2, 3, 4]
    parts = paddle.split(x, 2, axis=2)
    assert len(parts) == 2 and parts[0].shape == [2, 3, 2]
    parts = paddle.split(x, [1, -1], axis=1)
    assert parts[0].shape == [2, 1, 4] and parts[1].shape == [2, 2, 4]
    assert x.flatten().shape == [24] and x.flatten(1, 2).shape == [2, 12]
    assert paddle.unsqueeze(x, 0).shape == [1, 2, 3, 4]
    assert paddle.squeeze(paddle.ones([1, 3, 1]), axis=0).shape == [3, 1]


def test_indexing(paddle):
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_allclose(x[1].numpy(), [4, 5, 6, 7])
    np.testing.assert_allclose(x[:, 1].numpy(), [1, 5, 9])
    np.testing.assert_allclose(x[1:, 2:].numpy(), [[6, 7], [10, 11]])
    x[0] = paddle.zeros([4])
    np.testing.assert_allclose(x[0].numpy(), [0, 0, 0, 0])
    idx = paddle.to_tensor([2, 0])
    np.testing.assert_allclose(x[idx].numpy(), [[8, 9, 10, 11], [0, 0, 0, 0]])


def test_comparison_and_where(paddle):
    a = paddle.to_tensor([1.0, 5.0, 3.0])
    b = paddle.to_tensor([4.0, 2.0, 3.0])
    np.testing.assert_array_equal((a > b).numpy(), [False, True, False])
    np.testing.assert_allclose(paddle.where(a > b, a, b).numpy(), [4, 5, 3])
    np.testing.assert_allclose(paddle.maximum(a, b).numpy(), [4, 5, 3])


def test_gather_topk_sort(paddle):
    x = paddle.to_tensor([3.0, 1.0, 4.0, 1.0, 5.0])
    vals, idx = paddle.topk(x, 2)
    np.testing.assert_allclose(vals.numpy(), [5, 4])
    np.testing.assert_array_equal(idx.numpy(), [4, 2])
    g = paddle.gather(x, paddle.to_tensor([0, 2]))
    np.testing.assert_allclose(g.numpy(), [3, 4])
    np.testing.assert_allclose(paddle.sort(x).numpy(), [1, 1, 3, 4, 5])
    np.testing.assert_array_equal(paddle.argsort(x, descending=True).numpy(),
                                  [4, 2, 0, 3, 1])


def test_cast_dtype(paddle):
    x = paddle.ones([2], dtype="float32")
    y = x.astype("bfloat16")
    assert _dtype_name(y) == "bfloat16"
    z = y.astype(paddle.int32)
    assert z.numpy().dtype == np.int32


def test_creation_random_reproducible(paddle):
    paddle.seed(42)
    a = paddle.randn([4, 4])
    paddle.seed(42)
    b = paddle.randn([4, 4])
    np.testing.assert_allclose(a.numpy(), b.numpy())
    u = paddle.uniform([100], min=-2, max=2)
    assert float(u.min()) >= -2 and float(u.max()) <= 2


def test_einsum(paddle):
    paddle.seed(1)
    a = paddle.randn([2, 3])
    b = paddle.randn([3, 4])
    out = paddle.einsum("ij,jk->ik", a, b)
    np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the two packages give the same values
# ---------------------------------------------------------------------------

_OPS = {
    "reductions": lambda p, x: [x.sum(axis=1), x.mean(), x.prod(axis=0),
                                x.max(), x.min(axis=1, keepdim=True),
                                x.logsumexp(axis=-1), x.std(axis=0),
                                x.var(unbiased=False), x.argmax(axis=1),
                                x.argmin(), x.cumsum(axis=1), x.median(),
                                p.quantile(x, 0.3, axis=1)],
    "elementwise": lambda p, x: [p.exp(x), p.abs(x), p.sigmoid(x),
                                 p.tanh(x), p.erf(x), p.sign(x),
                                 p.clip(x, -0.5, 0.5), p.scale(x, 2.0, 1.0),
                                 p.square(x), p.floor(x), p.round(x * 3)],
    "shape": lambda p, x: [x.reshape([3, 8]), x.transpose([1, 0]),
                           p.tile(x, [2, 1]), p.flip(x, [0]),
                           p.roll(x, 1, axis=1), p.tril(x), p.triu(x, 1),
                           p.expand(x[:1], [3, 8]), p.moveaxis(x, 0, 1),
                           p.repeat_interleave(x, 2, axis=0), x.t(),
                           p.diagonal(x), p.kron(x, x[:1, :2])],
    "indexing": lambda p, x: [
        p.gather(x, p.to_tensor([2, 0]), axis=0),
        p.index_sample(x, p.to_tensor([[0, 1], [2, 3], [4, 5]])),
        p.take_along_axis(x, p.to_tensor([[1], [0], [7]]), 1),
        p.put_along_axis(x, p.to_tensor([[1], [0], [7]]),
                         p.to_tensor([[9.0], [9.0], [9.0]]), 1),
        p.scatter(x, p.to_tensor([1]), p.ones([1, 8])),
        p.masked_fill(x, x > 0, 0.0),
        p.gather_nd(x, p.to_tensor([[0, 1], [2, 3]])),
        p.topk(x, 3, axis=1, largest=False)[0],
        p.one_hot(p.to_tensor([0, 2]), 3), p.kthvalue(x, 2, axis=1)[0]],
}


@pytest.mark.parametrize("family", sorted(_OPS))
def test_op_families_match_the_reference(family):
    x_np = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    ref, port = _both(lambda p: _OPS[family](p, p.to_tensor(x_np)))
    assert len(ref) == len(port)
    for r, t in zip(ref, port):
        assert t.dtype == r.dtype, (family, t.dtype, r.dtype)
        np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# dtypes: the reference's x64-off results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda p: p.to_tensor([1, 2, 3]),
    lambda p: p.to_tensor(np.arange(3, dtype=np.int64)),
    lambda p: p.to_tensor(np.ones(3, np.float64)),
    lambda p: p.to_tensor([1.5, 2.0]),
    lambda p: p.to_tensor(np.ones(3, np.float32), dtype="float64"),
    lambda p: p.arange(5),
    lambda p: p.arange(0.0, 1.0, 0.25),
    lambda p: p.zeros([2], dtype="int64"),
    lambda p: p.ones([2]).astype("int64"),
    lambda p: p.argmax(p.to_tensor([1.0, 3.0])),
    lambda p: p.topk(p.to_tensor([1.0, 3.0]), 1)[1],
    lambda p: p.randint(0, 5, [3]),
    lambda p: p.to_tensor([True, False]),
    lambda p: p.shape(p.ones([2, 3])),
    lambda p: p.numel(p.ones([2, 3])),
    lambda p: p.to_tensor([1, 2]) + 1.5,
    lambda p: p.to_tensor([3, 4]) / p.to_tensor([2, 2]),
    lambda p: p.sum(p.to_tensor([True, True])),
])
def test_result_dtypes_are_the_reference_ones(make):
    ref, port = make(JP), make(TP)
    assert _dtype_name(port) == _dtype_name(ref)
    np.testing.assert_allclose(_np(port), _np(ref), rtol=1e-6)


def test_dtype_names_and_checks():
    from paddle_tpu_torch.core import dtype as D
    assert TP.int32 is torch.int32 and TP.bfloat16 is torch.bfloat16
    assert D.canonical_dtype("int64") == torch.int32
    assert D.canonical_dtype(np.float64) == torch.float32
    assert D.convert_dtype("paddle.float16") == torch.float16
    assert D.dtype_name(torch.bfloat16) == "bfloat16"
    assert D.is_integer("int16") and not D.is_integer(torch.bool)
    assert D.is_floating_point("bfloat16")
    x = TP.to_tensor([1, 2])
    assert x.dtype == TP.int32
    with pytest.raises(ValueError):
        D.convert_dtype("float128")


# ---------------------------------------------------------------------------
# places
# ---------------------------------------------------------------------------

def test_places_and_devices():
    assert TP.get_device() == "cpu:0"
    assert TP.to_tensor([1.0]).place == TP.CPUPlace()
    assert TP.CUDAPlace(1) == TP.CUDAPlace(1) != TP.CPUPlace(1)
    assert TP.XLAPlace is TP.TPUPlace and not TP.is_compiled_with_tpu()
    assert TP.set_device("gpu:1") == TP.CUDAPlace(1)
    assert TP.get_device() == "gpu:1"
    TP.set_device("cpu")
    with pytest.raises(ValueError):
        TP.set_device("npu")
    with pytest.raises(RuntimeError):
        TP.set_device("tpu")
        TP.zeros([1])


def test_default_place_is_the_card():
    """Without set_device the place is CUDAPlace(0); with no card the
    first tensor made there raises and names set_device("cpu")."""
    tplace._current_place[0] = None
    assert tplace.current_place() == TP.CUDAPlace(0)
    assert TP.get_device() == "gpu:0"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
        TP.to_tensor([1.0])


def test_importing_the_package_touches_no_torch():
    import subprocess
    import sys
    code = ("import sys, paddle_tpu_torch; "
            "assert 'torch' not in sys.modules, 'torch imported'; "
            "paddle_tpu_torch.in_dynamic_mode(); "
            "assert 'torch' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_later_names_raise_not_ported():
    for name in ("vision", "linalg", "quantization"):
        with pytest.raises(NotImplementedError, match="not ported"):
            getattr(TP, name)
    # ported since: jit and static (the compiled-program slice)
    assert TP.jit.to_static is not None and TP.static.Executor is not None
    # ported since: the checkpoint tier, the data pipeline, nn whole, the
    # metrics and the high-level API
    assert TP.save is TP.framework.save and TP.load is TP.framework.load
    assert TP.ParamAttr is TP.nn.ParamAttr
    assert TP.metric.Accuracy is not None and TP.Model is TP.hapi.Model
    assert TP.summary is TP.hapi.summary
    assert TP.callbacks.VisualDL is TP.hapi.callbacks.VisualDL
    assert TP.io.DataLoader is not None
    assert TP.in_dynamic_mode()
    TP.enable_static()
    assert not TP.in_dynamic_mode()
    TP.disable_static()


# ---------------------------------------------------------------------------
# __setitem__ under grad, hooks, Parameters
# ---------------------------------------------------------------------------

def test_setitem_under_grad():
    """y = 2x, then y[1] = 10·x[0], loss Σ y². The values agree. The
    gradient: the port's is the analytic one, (8 + 200, 0, 24). The
    reference's tape rebinds ``y`` onto the setitem node whose input is
    ``y`` itself, so the gradient into the pre-setitem ``y`` (2x) is
    dropped: (200, 0, 0) — a stated difference (ROADMAP)."""
    got = []
    for p in (JP, TP):
        x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        y = x * 2
        y[1] = p.to_tensor(10.0) * x[0]
        (y * y).sum().backward()
        got.append((_np(y), _np(x.grad)))
    np.testing.assert_allclose(got[1][0], got[0][0])
    np.testing.assert_allclose(got[1][1], [208.0, 0.0, 24.0])
    np.testing.assert_allclose(got[0][1], [200.0, 0.0, 0.0])


def test_setitem_on_a_leaf_rebinds_out_of_place():
    x = TP.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    leaf = x._value
    x[0] = 5.0
    assert x._value is not leaf and leaf.tolist() == [1.0, 2.0, 3.0]
    (x * x).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), [0.0, 4.0, 6.0])


def test_register_hook_replaces_the_gradient():
    got = []
    for p in (JP, TP):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        seen = []
        h = x.register_hook(lambda g: (seen.append(_np(g)), g * 3)[1])
        (x * x).sum().backward()
        h.remove()
        (x * x).sum().backward()
        got.append((seen, _np(x.grad)))
        with pytest.raises(RuntimeError):
            p.to_tensor([1.0]).register_hook(lambda g: g)
    np.testing.assert_allclose(got[1][0][0], got[0][0][0])
    np.testing.assert_allclose(got[1][1], got[0][1])


def test_hook_on_an_intermediate():
    for p in (JP, TP):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        h = x * 2
        h.register_hook(lambda g: g * 0.5)
        (h * h).sum().backward()
        np.testing.assert_allclose(_np(x.grad), [4.0, 8.0])


def test_parameter_and_stop_gradient():
    w = TP.Parameter(np.ones((2, 2), np.float32), name="w")
    assert not w.stop_gradient and w.trainable and w.persistable
    assert w.name == "w" and w._value.requires_grad
    assert w.optimize_attr == {"learning_rate": 1.0} and w.need_clip
    w.need_clip = False
    assert w._value.need_clip is False
    w.set_value(np.full((2, 2), 3.0))
    assert w._value.requires_grad and float(w.sum()) == 12.0
    frozen = TP.Parameter(np.ones(2, np.float32), trainable=False)
    assert frozen.stop_gradient and not frozen._value.requires_grad
    x = TP.to_tensor([1.0])
    assert x.stop_gradient and x.grad is None
    x.stop_gradient = False
    assert x._value.requires_grad
    y = x * 2
    y.stop_gradient = True
    assert not y._value.requires_grad and y.detach().stop_gradient


def test_tensor_host_bridge_and_iteration():
    x = TP.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2))
    assert [r.tolist() for r in x] == [[0, 1], [2, 3], [4, 5]]
    assert len(x) == 3 and x.size == 6 and x.ndim == 2 and x.numel() == 6
    assert np.asarray(x).shape == (3, 2) and float(x[1, 1]) == 3.0
    assert x.astype("bfloat16").numpy().dtype == np.float32
    assert "Tensor(shape=[3, 2]" in repr(x)
    with pytest.raises(TypeError):
        len(TP.to_tensor(1.0))
