"""The port's autograd surface (``core.autograd`` over torch's autograd,
``paddle_tpu_torch.autograd``'s ``grad``, ``jacobian`` and ``PyLayer``)
against the JAX package's tape: the scenarios of ``tests/test_autograd.py``
run through both packages, then ``PyLayer``, ``jacobian`` and the
reference's error types and messages. The port runs on the CPU."""

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


# ---------------------------------------------------------------------------
# the scenarios of tests/test_autograd.py, in both packages
# ---------------------------------------------------------------------------

def test_simple_backward(paddle):
    x = paddle.to_tensor([2.0, 3.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])


def test_chain(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = paddle.exp(x)
    z = (y * 3).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), 3 * np.exp([1.0, 2.0]), rtol=1e-6)


def test_grad_accumulation(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])
    x.clear_grad()
    assert x.grad is None


def test_stop_gradient(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.to_tensor([2.0], stop_gradient=True)
    z = (x * y).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
    assert y.grad is None


def test_no_grad_context(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient
    assert paddle.is_grad_enabled()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled()
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient


def test_detach(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = x * 2
    d = y.detach()
    assert d.stop_gradient
    np.testing.assert_allclose(d.numpy(), [6.0])


def test_matmul_grad_numeric(paddle):
    rng = np.random.RandomState(0)
    a_np = rng.randn(3, 4).astype(np.float32)
    b_np = rng.randn(4, 5).astype(np.float32)
    a = paddle.to_tensor(a_np, stop_gradient=False)
    b = paddle.to_tensor(b_np, stop_gradient=False)
    out = paddle.matmul(a, b).sum()
    out.backward()
    np.testing.assert_allclose(a.grad.numpy(),
                               np.ones((3, 5)) @ b_np.T, rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(),
                               a_np.T @ np.ones((3, 5)), rtol=1e-5)


def test_branching_graph(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y1 = x * 3
    y2 = x * 4
    z = (y1 + y2).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), [7.0])


def test_multi_output_op(paddle):
    x = paddle.to_tensor(np.array([[3.0, 1.0], [2.0, 4.0]], np.float32),
                         stop_gradient=False)
    vals, idx = paddle.topk(x, 1, axis=1)
    vals.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[1, 0], [0, 1]])


def test_paddle_grad_api(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = (x ** 3).sum()
    (gx,) = paddle.autograd.grad(y, x)
    np.testing.assert_allclose(gx.numpy(), 3 * np.array([1.0, 4.0]), rtol=1e-6)
    assert x.grad is None  # grad() must not pollute .grad
    assert gx.stop_gradient


def test_pylayer(paddle):
    class Double(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    x = paddle.to_tensor([1.5], stop_gradient=False)
    y = Double.apply(x)
    y.sum().backward()
    np.testing.assert_allclose(y.numpy(), [3.0])
    np.testing.assert_allclose(x.grad.numpy(), [2.0])


def test_retain_graph(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [8.0])


def test_double_backward_raises(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError, match="backward through the graph a "
                                           "second time"):
        y.backward()


def test_double_backward_raises_where_torch_would_not(paddle):
    """A graph that saved no tensor (an add) still counts as released."""
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = (x + 1).sum()
    y.backward()
    with pytest.raises(RuntimeError, match="retain_graph=True"):
        y.backward()


def test_grad_does_not_pollute_other_leaves(paddle):
    w = paddle.to_tensor([3.0], stop_gradient=False)
    x = paddle.to_tensor([2.0], stop_gradient=False)
    out = (w * x).sum()
    (gx,) = paddle.autograd.grad(out, x, retain_graph=True)
    np.testing.assert_allclose(gx.numpy(), [3.0])
    assert w.grad is None and x.grad is None


def test_grad_of_intermediate(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    h = x * 3
    y = (h * h).sum()
    (gh,) = paddle.autograd.grad(y, h)
    np.testing.assert_allclose(gh.numpy(), [12.0])


def test_backward_through_int_output_op(paddle):
    x = paddle.to_tensor(np.array([[3.0, 1.0, 2.0]], np.float32),
                         stop_gradient=False)
    vals, idx = paddle.topk(x, 2)
    vals.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[1, 0, 1]])


# ---------------------------------------------------------------------------
# the reference's semantics where torch's differ
# ---------------------------------------------------------------------------

def test_non_scalar_backward_seeds_ones(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (x * x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0, 6.0])
    z = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (z * 3).backward(paddle.to_tensor([1.0, -1.0]))
    np.testing.assert_allclose(z.grad.numpy(), [3.0, -3.0])


def test_unused_input_raises_value_error(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    u = paddle.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).sum()
    with pytest.raises(ValueError, match="unused"):
        paddle.autograd.grad(y, [x, u], retain_graph=True)
    gx, gu = paddle.autograd.grad(y, [x, u], allow_unused=True)
    assert gu is None
    np.testing.assert_allclose(gx.numpy(), [2.0])


def test_backward_of_a_tensor_without_graph_is_a_no_op(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    x.backward()
    assert x.grad is None
    paddle.to_tensor([1.0]).backward()


def test_grad_with_grad_outputs_and_two_outputs(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y1 = x * x
    y2 = (x * 3).sum()
    gs = paddle.autograd.grad([y1, y2], [x],
                              grad_outputs=[paddle.to_tensor([1.0, 0.5]),
                                            None])
    np.testing.assert_allclose(gs[0].numpy(), [2.0 + 3.0, 2.0 + 3.0])


def test_pylayer_two_inputs_and_a_constant(paddle):
    class MulAdd(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b, c):
            ctx.save_for_backward(a, b)
            return a * b + c

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensor
            return g * b, g * a

    a = paddle.to_tensor([2.0, 3.0], stop_gradient=False)
    b = paddle.to_tensor([5.0, 7.0], stop_gradient=False)
    out = MulAdd.apply(a, b, 1.0)
    np.testing.assert_allclose(out.numpy(), [11.0, 22.0])
    (out * out).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [2 * 11 * 5, 2 * 22 * 7])
    np.testing.assert_allclose(b.grad.numpy(), [2 * 11 * 2, 2 * 22 * 3])
    with paddle.no_grad():
        assert MulAdd.apply(a, b, 0.0).stop_gradient


@pytest.mark.parametrize("batch_axis", [None, 0])
def test_jacobian_matches_the_reference(batch_axis):
    xs_np = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    got = []
    for p in (JP, TP):
        x = p.to_tensor(xs_np, stop_gradient=False)
        w = p.to_tensor(np.arange(8, dtype=np.float32).reshape(4, 2) / 8)
        y = p.tanh(p.matmul(x, w))
        jac = p.autograd.jacobian(y, x, batch_axis=batch_axis)
        got.append(_np(jac))
    assert got[1].shape == got[0].shape
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)


def test_jacobian_over_a_list_of_inputs():
    x = TP.to_tensor([1.0, 2.0], stop_gradient=False)
    u = TP.to_tensor([3.0], stop_gradient=False)
    y = x * x
    jx, ju = TP.autograd.jacobian(y, [x, u])
    np.testing.assert_allclose(jx.numpy(), np.diag([2.0, 4.0]))
    np.testing.assert_allclose(ju.numpy(), np.zeros((2, 1)))
    with pytest.raises(ValueError):
        TP.autograd.jacobian(y, x, batch_axis=1)


def test_hessian_raises_as_the_reference_does(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(NotImplementedError):
        paddle.autograd.hessian((x * x).sum(), x)


def test_the_tape_internals_are_refused():
    from paddle_tpu_torch.core import autograd as A
    x = TP.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(ValueError):
        A.backward((x * 2).sum(), capture={})
    with pytest.raises(ValueError):
        TP.Tensor(np.ones(2, np.float32), _grad_node=object())
