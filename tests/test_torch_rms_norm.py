"""RMSNorm forward: the PyTorch port (``paddle_tpu_torch.ops.rms_norm``)
against the JAX package — its XLA reference and its Pallas kernel in
interpret mode — on the same numpy inputs. On the CPU the port runs its
plain version; the Triton kernel is held against that version on the
card (tests/test_torch_gpu.py)."""

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
