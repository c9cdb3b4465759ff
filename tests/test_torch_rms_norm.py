"""RMSNorm forward and backward: the PyTorch port (``paddle_tpu_torch.ops.rms_norm``)
against the JAX package — its XLA reference and its Pallas kernel in
interpret mode — on the same numpy inputs. On the CPU the port runs its
plain version; the Triton kernel is held against that version on the
card (tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import rms_norm as jrn
from paddle_tpu_torch.ops import rms_norm as trn

# fp32: both compute in fp32 and differ only in summation order
FP32 = dict(rtol=1e-6, atol=1e-6)
# bf16 inputs and output: compared in fp32; bf16 keeps 8 mantissa bits,
# so one rounding step of an O(1) output is up to ~1e-2
BF16 = dict(rtol=0, atol=1e-2)


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(16, 128), (1, 12, 128), (3, 7, 64),
                                   (5, 100)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_plain_matches_jax_reference_fp32(shape, eps):
    x, w = _inputs(shape)
    want = np.asarray(jrn.rms_norm_array(jnp.asarray(x), jnp.asarray(w),
                                         eps))
    got = trn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("shape", [(16, 128), (1, 12, 128)])
def test_plain_matches_jax_reference_bf16(shape):
    x, w = _inputs(shape, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jrn.rms_norm_array(xj, wj, 1e-6).astype(jnp.float32))
    got = trn.rms_norm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_interpret(dtype):
    """The Pallas kernel the port's Triton kernel replaces, run in
    interpret mode at (rows, h) = (16, 128)."""
    x, w = _inputs((16, 128), seed=2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jrn._pallas_fwd(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6,
                           interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = trn.rms_norm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt), 1e-6).float().numpy()
    np.testing.assert_allclose(got, want,
                               **(FP32 if dtype == "float32" else BF16))


def test_ragged_step_shape_three_d():
    """(1, T, h) — the shape ragged_step hands the op — matches the 2-D
    rows of the same data."""
    x, w = _inputs((1, 9, 128), seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(trn.rms_norm(xt, wt)[0].numpy(),
                                  trn.rms_norm(xt[0], wt).numpy())


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    x, w = _inputs((4, 64))
    before = trn.rms_norm.launches
    out = trn.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert trn.rms_norm.launches == before
    np.testing.assert_array_equal(
        out.numpy(),
        trn.rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel path raises on a CPU tensor instead of falling back."""
    x, w = _inputs((4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        trn.rms_norm_kernel(torch.from_numpy(x), torch.from_numpy(w))


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

# fp32 backward: the reference's RMSNorm tolerance (test_fused_ops.py)
BWD32 = dict(rtol=1e-5, atol=1e-5)


def _vjp_jax(x, w, g, eps):
    _, vjp = jax.vjp(lambda a, b: jrn.rms_norm_array(a, b, eps),
                     jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 128), (3, 7, 64),
                                   (5, 100)])
def test_bwd_plain_matches_jax_vjp_fp32(shape):
    x, w = _inputs(shape, seed=4)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want_dx, want_dw = _vjp_jax(x, w, g, 1e-5)
    dx, dw = trn.rms_norm_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(g), 1e-5)
    assert dx.shape == x.shape and tuple(dw.shape) == (shape[-1],)
    np.testing.assert_allclose(dx.numpy(), want_dx, **BWD32)
    np.testing.assert_allclose(dw.numpy(), want_dw, **BWD32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_pallas_kernel_interpret(dtype):
    """The Pallas backward the port's Triton kernels replace, in
    interpret mode at (rows, h) = (32, 256): dx in x's dtype, dw in
    fp32 there (cast to w's dtype by ``_rms_bwd``)."""
    x, w = _inputs((32, 256), seed=6)
    g = np.random.RandomState(7).randn(32, 256).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want_dx, want_dw = jrn._pallas_bwd(jnp.asarray(x, jdt),
                                       jnp.asarray(w, jdt),
                                       jnp.asarray(g, jdt), 1e-6,
                                       interpret=True)
    dx, dw = trn.rms_norm_bwd_plain(*(torch.from_numpy(a).to(tdt)
                                      for a in (x, w, g)), 1e-6)
    assert dx.dtype == tdt and dw.dtype == tdt
    tol = BWD32 if dtype == "float32" else BF16
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(want_dw.astype(jdt).astype(
                                   jnp.float32)),
                               **(tol if dtype == "float32" else
                                  dict(rtol=1.6e-2, atol=1e-2)))


def test_autograd_grads_match_jax_vjp():
    x, w = _inputs((2, 9, 128), seed=8)
    g = np.random.RandomState(9).randn(2, 9, 128).astype(np.float32)
    want_dx, want_dw = _vjp_jax(x, w, g, 1e-5)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = trn.rms_norm(xt, wt, 1e-5)
    assert "RMSNormFunction" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **BWD32)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, **BWD32)


def test_no_grad_is_the_forward_alone():
    """Serving runs under no_grad: no autograd node, the same output."""
    x, w = _inputs((4, 64), seed=10)
    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        y = trn.rms_norm(xt, torch.from_numpy(w))
    assert y.grad_fn is None and not y.requires_grad
    np.testing.assert_array_equal(
        y.numpy(), trn.rms_norm_plain(xt.detach(), torch.from_numpy(w)).numpy())


def test_bwd_cpu_takes_plain_and_kernel_refuses_cpu():
    x, w = _inputs((4, 64))
    g = torch.ones(4, 64)
    before = trn.rms_norm_bwd.launches
    trn.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w), g)
    assert trn.rms_norm_bwd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        trn.rms_norm_bwd_kernel(torch.from_numpy(x), torch.from_numpy(w), g)
