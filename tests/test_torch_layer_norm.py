"""LayerNorm: the PyTorch port (``paddle_tpu_torch.ops.layer_norm_fused``)
against the JAX package on the same numpy inputs — its plain path
(``_ln_ref``/``_ln_bwd``) and its Pallas kernels in interpret mode. On
the CPU the port runs its plain versions; the Triton kernels are held
against those on the card (tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import layer_norm_fused as jln
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_transformer_block as tftb
from paddle_tpu_torch.ops import layer_norm_fused as tln

# fp32: the same math with sums in other orders
FP32 = dict(rtol=1e-5, atol=1e-5)
# dw/db sum every row: a longer chain of fp32 sums
SUMS = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs compared in fp32: one bf16 rounding step (8 mantissa bits)
# of an fp32 value that differs in its last bits
BF16 = dict(rtol=1.6e-2, atol=1.6e-2)

ROWS, H = 64, 256      # a multiple of 128 wide, as the Pallas kernel takes


def _inputs(dtype, seed, rows=ROWS, h=H):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, h) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    j = [jnp.asarray(a, jd) for a in (x, w, b, g)]
    t = [torch.from_numpy(a).to(td) for a in (x, w, b, g)]
    return j, t


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      a.astype(jnp.float32))


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_plain_versions_match_jax(oracle, dtype, eps):
    """ln_plain / ln_bwd_plain against the JAX package's plain path and
    against its Pallas kernels run in interpret mode."""
    (jx, jw, jb, jg), (x, w, b, g) = _inputs(dtype, seed=int(eps < 1e-6))
    if oracle == "xla":
        y = jln._ln_ref(jx, jw, jb, eps)
        dx, dw, db = jln._ln_bwd(eps, (jx, jw, jb), jg)
    else:
        y = jln._pallas_fwd(jx, jw, jb, eps, interpret=True)
        dx, dw, db = jln._pallas_bwd(jx, jw, jg, eps, interpret=True)
    got_y = tln.ln_plain(x, w, b, eps)
    gdx, gdw, gdb = tln.ln_bwd_plain(x, w, g, eps)
    assert got_y.dtype == x.dtype and gdx.dtype == x.dtype
    assert gdw.dtype == w.dtype and gdb.dtype == w.dtype
    tol, sums = (BF16, BF16) if dtype == "bf16" else (FP32, SUMS)
    np.testing.assert_allclose(_np(got_y), _np(y), **tol)
    np.testing.assert_allclose(_np(gdx), _np(dx), err_msg="dx", **tol)
    np.testing.assert_allclose(_np(gdw), _np(dw), err_msg="dw", **sums)
    np.testing.assert_allclose(_np(gdb), _np(db), err_msg="db", **sums)


def test_autograd_matches_jax_custom_vjp():
    """``layer_norm`` (the autograd Function) against ``jax.vjp`` of
    ``layer_norm_fused`` on (2, 5, 96) rows: a width the Pallas kernel
    does not take, so the JAX side runs its plain path."""
    rng = np.random.RandomState(3)
    x, g = (rng.randn(2, 5, 96).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.randn(96)).astype(np.float32)
    b = (0.1 * rng.randn(96)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, c, d: jln.layer_norm_fused(a, c, d, 1e-12),
                     *(jnp.asarray(a) for a in (x, w, b)))
    want = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = tln.layer_norm(tx, tw, tb, 1e-12)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **FP32)
    out.backward(torch.from_numpy(g))
    for name, t, wnt in zip(("dx", "dw", "db"), (tx, tw, tb), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt),
                                   err_msg=name, **SUMS)


@pytest.mark.parametrize("scale,bias", [(True, True), (True, False),
                                        (False, False)])
def test_layer_norm_array_and_functional_match_jax(scale, bias):
    from paddle_tpu.ops import fused_transformer_block as jftb
    rng = np.random.RandomState(4)
    x = rng.randn(3, 7, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32) if scale else None
    b = (0.1 * rng.randn(64)).astype(np.float32) if bias else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = np.asarray(jftb.layer_norm_array(j(x), j(w), j(b), 1e-5))
    got = tftb.layer_norm_array(t(x), t(w), t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    got_f = TF.layer_norm(t(x), 64, t(w), t(b), 1e-5)
    np.testing.assert_allclose(got_f.numpy(), want, **FP32)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    _, (x, w, b, g) = _inputs("fp32", seed=5)
    before = (tln.layer_norm.launches, tln.layer_norm_bwd.launches)
    xt = x.clone().requires_grad_(True)
    out = tln.layer_norm(xt, w, b, 1e-5)
    out.backward(g)
    assert (tln.layer_norm.launches, tln.layer_norm_bwd.launches) == before
    assert torch.equal(out.detach(), tln.ln_plain(x, w, b, 1e-5))
    assert torch.equal(xt.grad, tln.ln_bwd_plain(x, w, g, 1e-5)[0])


def test_kernel_wrappers_refuse_cpu_tensors():
    _, (x, w, b, g) = _inputs("fp32", seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_kernel(x, w, b, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_bwd_kernel(x, w, g, 1e-5)
