"""Flash attention: the PyTorch port (``paddle_tpu_torch.ops.flash_attention``)
against the JAX package on the same numpy inputs — its Pallas kernels in
interpret mode, its XLA reference path and the differentiable
``_sdpa_array``. On the CPU the port runs its plain versions; the CUDA
kernels are held against those on the card (tests/test_torch_gpu.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

# the reference's own tolerances for its flash kernels
# (tests/test_ring_attention.py): forward 2e-4, backward 2e-3
FWD = dict(rtol=2e-4, atol=2e-4)
BWD = dict(rtol=2e-3, atol=2e-3)
# bf16 inputs and outputs, compared in fp32: one bf16 rounding step of an
# O(1) value, plus P rounded to bf16 at other points of the online softmax
BF16 = dict(rtol=2e-2, atol=2e-2)


def _qkv(bh, sq, sk, d, rep=1, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, sq, d).astype(np.float32)
    k = rng.randn(bh // rep, sk, d).astype(np.float32)
    v = rng.randn(bh // rep, sk, d).astype(np.float32)
    g = rng.randn(bh, sq, d).astype(np.float32)
    return q, k, v, g


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# (causal, kv_rep, kv_valid, causal_offset): plain, GQA, padded keys, and
# the end-aligned decode offset
CASES = [(True, 1, None, 0), (False, 1, None, 0), (True, 2, None, 0),
         (False, 2, None, 0), (True, 1, 50, 0), (False, 1, 40, 0),
         (True, 1, None, 16)]


@pytest.mark.parametrize("causal,rep,kv_valid,offset", CASES)
def test_plain_matches_pallas_kernels_interpret(causal, rep, kv_valid,
                                                offset):
    """flash_fwd_plain / flash_bwd_plain against _flash_fwd_pallas /
    _flash_bwd_pallas in interpret mode at (BH, S, D) = (4, 64, 32) with
    16x32 blocks."""
    q, k, v, g = _qkv(4, 64, 64, 32, rep)
    sc = 1.0 / math.sqrt(32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, sc, causal, 16, 32,
                                     kv_valid=kv_valid, causal_offset=offset,
                                     interpret=True, kv_rep=rep)
    dq, dk, dv = jfa._flash_bwd_pallas(jq, jk, jv, out, lse, jg, sc, causal,
                                       16, 32, kv_valid=kv_valid,
                                       causal_offset=offset, interpret=True,
                                       kv_rep=rep)
    tout, tlse = tfa.flash_fwd_plain(_t(q), _t(k), _t(v), sc, causal,
                                     kv_valid, offset, rep)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **FWD)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **FWD)
    grads = tfa.flash_bwd_plain(_t(q), _t(k), _t(v), tout, tlse, _t(g), sc,
                                causal, kv_valid, offset, rep)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **BWD)


def test_plain_matches_pallas_kernels_interpret_bf16():
    q, k, v, g = _qkv(4, 64, 64, 32, rep=2, seed=1)
    sc = 1.0 / math.sqrt(32)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, sc, True, 16, 32,
                                     interpret=True, kv_rep=2)
    dq, dk, dv = jfa._flash_bwd_pallas(jq, jk, jv, out, lse, jg, sc, True,
                                       16, 32, interpret=True, kv_rep=2)
    bf = torch.bfloat16
    tout, tlse = tfa.flash_fwd_plain(_t(q, bf), _t(k, bf), _t(v, bf), sc,
                                     True, kv_rep=2)
    assert tout.dtype == bf and tlse.dtype == torch.float32
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(out.astype(jnp.float32)), **BF16)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **FWD)
    grads = tfa.flash_bwd_plain(_t(q, bf), _t(k, bf), _t(v, bf), tout, tlse,
                                _t(g, bf), sc, True, kv_rep=2)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        assert got.dtype == bf, name
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   err_msg=name, **BF16)


@pytest.mark.parametrize("causal,kv_valid,offset", [
    (True, None, 0), (True, 30, 0), (False, 30, 0), (True, None, 9)])
def test_attn_ref_kv_plain_matches_jax(causal, kv_valid, offset):
    q, k, v, _ = _qkv(3, 24, 33, 16, seed=2)
    sc = 0.3
    want = jfa._attn_ref_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            sc, causal, kv_valid, offset)
    got = tfa.attn_ref_kv_plain(_t(q), _t(k), _t(v), sc, causal, kv_valid,
                                offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # where every row has a key to attend, the kernels' math is the same
    if kv_valid is None and offset == 0:
        offset = k.shape[1] - q.shape[1]      # _attn_ref's end alignment
    out, _ = tfa.flash_fwd_plain(_t(q), _t(k), _t(v), sc, causal, kv_valid,
                                 offset)
    np.testing.assert_allclose(out.numpy(), got.numpy(), **FWD)


def _sdpa_inputs(b, s, hq, hk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hk, d).astype(np.float32)
    v = rng.randn(b, s, hk, d).astype(np.float32)
    g = rng.randn(b, s, hq, d).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hk", [(4, 4), (4, 2), (6, 2)])
def test_sdpa_array_and_grads_match_jax(causal, hq, hk):
    """(B, S, H, D) at S = 40, which the reference pads to 128 and masks
    with kv_valid, and the port bound-checks; GQA without repeated KV."""
    q, k, v, g = _sdpa_inputs(2, 40, hq, hk, 16, seed=hq + hk)
    sc = 1.0 / math.sqrt(16)
    out, vjp = jax.vjp(lambda a, b_, c: jfa._sdpa_array(
        a, b_, c, scale=sc, causal=causal), *(jnp.asarray(x)
                                              for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    got = tfa.sdpa_array(tq, tk, tv, scale=sc, causal=causal)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    got.backward(_t(g))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **BWD)


def test_flash_attention_bhsd_end_aligned_matches_jax():
    """sq != sk with causal: row i attends cols <= i + sk - sq."""
    q, k, v, g = _qkv(2, 8, 20, 16, seed=3)
    out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_bhsd(
        a, b_, c, 0.25, True), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    got = tfa.flash_attention_bhsd(tq, tk, tv, 0.25, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    got.backward(_t(g))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **BWD)


def test_row_with_no_key_gives_zero_and_finite_grads():
    """As from the kernels (and the Pallas kernels): out 0, lse -1e30,
    and zero, finite gradients for a row that attends nothing."""
    q, k, v, g = _qkv(2, 8, 8, 16, seed=4)
    out, lse = tfa.flash_fwd_plain(_t(q), _t(k), _t(v), 0.25, True,
                                   causal_offset=-3)
    assert bool((out[:, :3] == 0).all()) and bool((lse[:, :3] == -1e30).all())
    grads = tfa.flash_bwd_plain(_t(q), _t(k), _t(v), out, lse, _t(g), 0.25,
                                True, causal_offset=-3)
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert bool((grads[0][:, :3] == 0).all())


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    q, k, v, g = _qkv(2, 16, 16, 16, seed=5)
    counters = (tfa.flash_fwd_kernel, tfa.flash_bwd_dq_kernel,
                tfa.flash_bwd_dkv_kernel)
    before = [c.launches for c in counters]
    tq = _t(q).requires_grad_(True)
    out = tfa.flash_attention_bhsd(tq, _t(k), _t(v), 0.25, True)
    out.backward(_t(g))
    assert [c.launches for c in counters] == before
    want, _ = tfa.flash_fwd_plain(_t(q), _t(k), _t(v), 0.25, True)
    assert torch.equal(out.detach(), want)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel paths raise on CPU tensors instead of falling back."""
    q, k, v, g = (_t(a) for a in _qkv(2, 16, 16, 64, seed=6))
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_kernel(q, k, v, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq_kernel(q, k, v, g, lse, lse, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv_kernel(q, k, v, g, lse, lse, 0.125, True)


@pytest.mark.parametrize("b", [1, 2])
def test_sdpa_array_hands_the_kernels_contiguous_rows(b, monkeypatch):
    """The kernels take contiguous (BH, S, D) rows; at B = 1 a reshape of
    the transposed heads alone would stay a strided view."""
    seen = []

    def spy(q, k, v, *args):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return tfa.flash_fwd_plain(q, k, v, *args)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    q, k, v, _ = _sdpa_inputs(b, 12, 4, 2, 16, seed=7)
    tfa.sdpa_array(_t(q), _t(k), _t(v), causal=True)
    assert seen == [True, True, True]


# ---------------------------------------------------------------------------
# segment ids (packed sequences)
# ---------------------------------------------------------------------------

def _segments(layout, s=256):
    """Packed rows with trailing pads (-1). ``rows``: one row per batch
    entry (R = 2), the second mostly pads, so its last query tile and
    every key tile it meets belong to other segments; ``shared``: one
    (S,) row for every bh."""
    if layout == "rows":
        seg = np.full((2, s), -1, np.int32)
        seg[0, :200] = np.repeat([0, 1, 2], [100, 60, 40])
        seg[1, :90] = 0
    else:
        seg = np.full((s,), -1, np.int32)
        seg[:220] = np.repeat([0, 1, 2], [70, 100, 50])
    # the JAX package's convention: pads never match pads
    return np.where(seg < 0, -1, seg), np.where(seg < 0, -2, seg)


@pytest.mark.parametrize("layout", ["rows", "shared"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_segmented_plain_matches_pallas_kernels_interpret(d, causal, layout):
    """flash_fwd_plain / flash_bwd_plain with segment ids against
    _flash_fwd_pallas / _flash_bwd_pallas(seg_q=, seg_k=) in interpret
    mode at (BH, S) = (4, 256) with 128x128 blocks: pad rows give out 0,
    lse -1e30 and zero, finite gradients."""
    q, k, v, g = _qkv(4, 256, 256, d, seed=d + causal)
    seg_q, seg_k = _segments(layout)
    sc = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    js = dict(seg_q=jnp.asarray(seg_q), seg_k=jnp.asarray(seg_k))
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, sc, causal, 128, 128,
                                     interpret=True, **js)
    dq, dk, dv = jfa._flash_bwd_pallas(jq, jk, jv, out, lse, jg, sc, causal,
                                       128, 128, interpret=True, **js)
    ts = dict(seg_q=torch.from_numpy(seg_q), seg_k=torch.from_numpy(seg_k))
    tout, tlse = tfa.flash_fwd_plain(_t(q), _t(k), _t(v), sc, causal, **ts)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **FWD)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **FWD)
    pads = tfa._seg_rows(ts["seg_q"], 4).expand(4, -1) < 0
    assert bool((tout[pads] == 0).all()) and bool((tlse[pads] == -1e30).all())
    grads = tfa.flash_bwd_plain(_t(q), _t(k), _t(v), tout, tlse, _t(g), sc,
                                causal, **ts)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        assert bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **BWD)
    assert bool((grads[0][pads] == 0).all())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_segmented_and_grads_match_jax(causal):
    """(B, nh, S, D) at S = 40, which the reference pads to 128 with
    segment id -1; the port bound-checks. Against the reference's
    ``flash_attention_segmented`` (its plain path here) and
    ``_seg_ref_batched``, forward and backward."""
    rng = np.random.RandomState(8 + causal)
    b, nh, s, d = 2, 3, 40, 16
    q, k, v, g = (rng.randn(b, nh, s, d).astype(np.float32)
                  for _ in range(4))
    seg = np.full((b, s), -1, np.int32)
    seg[0, :] = np.repeat([0, 1, 2], [10, 25, 5])
    seg[1, :31] = np.repeat([0, 1], [17, 14])
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_segmented(
        a, b_, c, jnp.asarray(seg), causal=causal), *jargs)
    want = vjp(jnp.asarray(g))
    ref = jfa._seg_ref_batched(*jargs, jnp.asarray(seg), 1 / math.sqrt(d),
                               causal)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = tfa.flash_attention_segmented(tq, tk, tv, torch.from_numpy(seg),
                                        causal=causal)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    plain_ref = tfa.seg_ref_batched_plain(_t(q), _t(k), _t(v),
                                          torch.from_numpy(seg),
                                          1 / math.sqrt(d), causal)
    np.testing.assert_allclose(plain_ref.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(got.detach().numpy(), plain_ref.numpy(),
                               **FWD)
    got.backward(_t(g))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **BWD)


def test_segmented_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = (_t(a) for a in _qkv(2, 16, 16, 64, seed=9))
    seg = torch.zeros(2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_kernel(q, k, v, 0.125, False, seg_q=seg, seg_k=seg)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_varlen_and_grads_match_jax(causal):
    """(total, H, D) packed tokens with cu_seqlens, one shared row of
    segment ids, against the reference's ``flash_attention_varlen`` (its
    plain path here); non-causal with a different packing of the keys."""
    rng = np.random.RandomState(20 + causal)
    cu_q = np.array([0, 7, 19, 30], np.int32)
    cu_k = cu_q if causal else np.array([0, 10, 14, 26], np.int32)
    h, d = 3, 16
    q, g = (rng.randn(30, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(int(cu_k[-1]), h, d).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_varlen(
        a, b_, c, jnp.asarray(cu_q), jnp.asarray(cu_k), causal=causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    got = tfa.flash_attention_varlen(tq, tk, tv, torch.from_numpy(cu_q),
                                     torch.from_numpy(cu_k), causal=causal)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    got.backward(_t(g))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **BWD)


def test_flash_attention_varlen_causal_needs_one_packing():
    q = torch.zeros(8, 2, 16)
    with pytest.raises(ValueError, match="cu_seqlens_q == cu_seqlens_k"):
        tfa.flash_attention_varlen(q, q, q, torch.tensor([0, 3, 8]),
                                   torch.tensor([0, 4, 8]))
