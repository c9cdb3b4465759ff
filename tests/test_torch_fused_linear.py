"""The weight-gradient accumulation op of the PyTorch port
(``paddle_tpu_torch.ops.fused_linear``) against the JAX package on the
CPU, on the same numpy inputs: ``fused_linear_param_grad_add`` against
the JAX op's XLA path and against the Pallas kernel ``_pallas_grad_add``
run in interpret mode, ``linear_with_main_grad``'s gradients against
``jax.grad``, and the fused products of ``incubate.nn.functional``. On
the CPU the port runs the kernel's plain version; tests/test_torch_gpu.py
holds the CUDA kernel against it on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops import fused_linear as JFL
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops import fused_linear as TFL
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# fp32 accumulators: the same exact products (bf16 products are exact in
# fp32) summed in another order by XLA and PyTorch; over 384 rows the
# outputs reach |60|, where a few fp32 steps are ~2e-5
F32 = dict(rtol=1e-5, atol=1e-4)
# a bf16 accumulator: XLA and the port both round the fp32 product to
# bf16, add and round again; the products differ in their last fp32 bits,
# so a rounding may go the other way by one bf16 step (2^-8)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)


def _np(a):
    return np.asarray(a._value if hasattr(a, "_value") else a, np.float32)


def _inputs(lead, din, dout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, din).astype(np.float32)
    g = rng.randn(*lead, dout).astype(np.float32)
    acc = rng.randn(din, dout).astype(np.float32) * 4
    bias = rng.randn(dout).astype(np.float32)
    return x, g, acc, bias


def _t(a, dtype):
    """A tensor of its own memory (the op may update it in place)."""
    return torch.from_numpy(a.copy()).to(dtype)


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("lead", [(48,), (2, 5, 7)], ids=["2d", "lead"])
@pytest.mark.parametrize("dtype,multi_precision", [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False),
    (torch.float32, False)], ids=["f32", "bf16-f32acc", "bf16-bf16acc",
                                  "f32-nomp"])
@pytest.mark.parametrize("given", [False, True], ids=["fresh", "given"])
@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
def test_op_matches_jax_xla_path(lead, dtype, multi_precision, given,
                                 has_bias):
    """Every combination of the op's arguments against the JAX op (its
    XLA path on the CPU): leading dims, input dtypes, the accumulator's
    dtype, accumulators given or ``None``, with and without a bias."""
    x, g, acc, bias = _inputs(lead, 24, 40)
    acc_dt = torch.float32 if multi_precision else dtype
    jdw, jdb = JFL.fused_linear_param_grad_add(
        jnp.asarray(x, _JDT[dtype]), jnp.asarray(g, _JDT[dtype]),
        jnp.asarray(acc, _JDT[acc_dt]) if given else None,
        jnp.asarray(bias, _JDT[acc_dt]) if given else None,
        multi_precision=multi_precision, has_bias=has_bias)
    dw, db = TFL.fused_linear_param_grad_add(
        _t(x, dtype), _t(g, dtype), _t(acc, acc_dt) if given else None,
        _t(bias, acc_dt) if given else None,
        multi_precision=multi_precision, has_bias=has_bias)
    assert dw.dtype == acc_dt and dw.shape == (24, 40)
    tol = F32 if acc_dt == torch.float32 else BF16
    np.testing.assert_allclose(dw.float().numpy(), _np(jdw), **tol)
    if has_bias:
        assert db.dtype == acc_dt
        np.testing.assert_allclose(db.float().numpy(), _np(jdb), **tol)
    else:
        assert db is None and jdb is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,din,dout", [(256, 128, 384), (384, 256, 128)])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(
        monkeypatch, dtype, rows, din, dout):
    """The plain version (the CUDA kernel's contract) against the Pallas
    kernel itself, run in interpret mode at shapes its tiling takes:
    rows a multiple of 128, din and dout of 128; fp32 accumulator."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x, g, acc, _ = _inputs((rows,), din, dout, seed=1)
    want = JFL._pallas_grad_add(jnp.asarray(x, _JDT[dtype]),
                                jnp.asarray(g, _JDT[dtype]),
                                jnp.asarray(acc))
    got = TFL.fused_linear_param_grad_add_plain(
        _t(x, dtype), _t(g, dtype), _t(acc, torch.float32), torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_accumulates_in_place_when_it_can():
    """Paddle's op and the Pallas alias update main_grad in place: a
    given accumulator of the right dtype, device and layout is the
    returned one, updated; one that needs converting (bf16 under
    ``multi_precision``, or not contiguous) is left as it was."""
    x, g, acc, bias = _inputs((16,), 8, 12, seed=2)
    dweight, dbias = _t(acc, torch.float32), _t(bias, torch.float32)
    want_w = acc + x.T @ g
    dw, db = TFL.fused_linear_param_grad_add(_t(x, torch.float32),
                                             _t(g, torch.float32), dweight,
                                             dbias)
    assert dw is dweight and db is dbias
    np.testing.assert_allclose(dweight.numpy(), want_w, **F32)
    np.testing.assert_allclose(dbias.numpy(), bias + g.sum(0), **F32)
    for other in (_t(acc, torch.bfloat16),
                  torch.from_numpy(np.ascontiguousarray(acc.T)).t()):
        before = other.clone()
        dw, _ = TFL.fused_linear_param_grad_add(
            _t(x, torch.float32), _t(g, torch.float32), other)
        assert dw is not other and dw.dtype == torch.float32
        assert torch.equal(other, before)
    with pytest.raises(ValueError, match="shape"):
        TFL.fused_linear_param_grad_add(_t(x, torch.float32),
                                        _t(g, torch.float32),
                                        torch.zeros(12, 8))


def test_non_contiguous_activation_is_read_as_its_values():
    """o_proj's input is a transposed attention output: the op reads its
    values whatever its strides."""
    rng = np.random.RandomState(3)
    xt = rng.randn(2, 4, 6, 8).astype(np.float32)        # (B, H, S, D)
    g = rng.randn(2, 6, 40).astype(np.float32)
    x = torch.from_numpy(xt).transpose(1, 2).reshape(2, 6, 32)
    dw, _ = TFL.fused_linear_param_grad_add(x, torch.from_numpy(g),
                                            has_bias=False)
    x2 = np.ascontiguousarray(xt.transpose(0, 2, 1, 3)).reshape(12, 32)
    np.testing.assert_allclose(dw.numpy(), x2.T @ g.reshape(12, 40), **F32)


def test_cpu_tensors_never_reach_the_kernel():
    """On the CPU the op runs the plain version (no launch counted); the
    kernel's wrapper itself refuses CPU tensors."""
    x, g, _, _ = _inputs((8,), 4, 4)
    before = TFL.fused_linear_grad_add_kernel.launches
    TFL.fused_linear_param_grad_add(_t(x, torch.float32),
                                    _t(g, torch.float32))
    assert TFL.fused_linear_grad_add_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        TFL.fused_linear_grad_add_kernel(_t(x, torch.float32),
                                         _t(g, torch.float32), None,
                                         torch.float32)


@pytest.mark.parametrize("has_bias", [True, False])
def test_linear_with_main_grad_gradients_match_jax_grad(has_bias):
    """``linear_with_main_grad``'s dx, dw, db against ``jax.grad`` of the
    JAX function (its custom_vjp), fp32, under the same cotangent."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 16).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    cot = rng.randn(3, 5, 24).astype(np.float32)
    bj = jnp.asarray(b) if has_bias else None

    def jloss(xv, wv, bv):
        return (JFL.linear_with_main_grad(xv, wv, bv) * cot).sum()

    jx, jw, jb = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x),
                                                   jnp.asarray(w), bj)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    bt = torch.from_numpy(b).requires_grad_() if has_bias else None
    y = TFL.linear_with_main_grad(xt, wt, bt)
    np.testing.assert_allclose(
        y.detach().numpy(),
        _np(JFL.linear_with_main_grad(jnp.asarray(x), jnp.asarray(w), bj)),
        **F32)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(jx), **F32)
    np.testing.assert_allclose(wt.grad.numpy(), _np(jw), **F32)
    if has_bias:
        np.testing.assert_allclose(bt.grad.numpy(), _np(jb), **F32)
    else:
        assert jb is None


@pytest.mark.parametrize("transpose_x", [False, True])
@pytest.mark.parametrize("transpose_y", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_matmul_bias_matches_jax(transpose_x, transpose_y, bias):
    """Transposes swap the last two dims of batched inputs."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, *((8, 6) if transpose_x else (6, 8))).astype(np.float32)
    y = rng.randn(2, *((10, 8) if transpose_y else (8, 10))).astype(
        np.float32)
    b = rng.randn(10).astype(np.float32)
    want = JIF.fused_matmul_bias(paddle.to_tensor(x), paddle.to_tensor(y),
                                 paddle.to_tensor(b) if bias else None,
                                 transpose_x=transpose_x,
                                 transpose_y=transpose_y)
    got = TIF.fused_matmul_bias(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(b) if bias else None,
                                transpose_x=transpose_x,
                                transpose_y=transpose_y)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


@pytest.mark.parametrize("transpose_weight", [False, True])
def test_fused_linear_matches_jax(transpose_weight):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 4, 8).astype(np.float32)
    w = rng.randn(*((10, 8) if transpose_weight else (8, 10))).astype(
        np.float32)
    b = rng.randn(10).astype(np.float32)
    want = JIF.fused_linear(paddle.to_tensor(x), paddle.to_tensor(w),
                            paddle.to_tensor(b),
                            transpose_weight=transpose_weight)
    got = TIF.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b),
                           transpose_weight=transpose_weight)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
