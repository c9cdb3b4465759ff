"""Ragged paged attention and the KV page manager: the PyTorch port
(``paddle_tpu_torch.ops.paged_attention``) against the JAX package — the
XLA array reference, the Pallas kernel in interpret mode and its
``PagedKVCacheManager`` — on the same numpy inputs. On the CPU the port
runs its plain version; the CUDA kernel is held against that version on
the card (tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa

# the JAX package's own tolerance for this kernel (test_unified_step.py)
FP32 = dict(rtol=1e-5, atol=1e-6)


def _mixed_batch(seed=0, PAGE=4, NPAGES=32, NKV=2, NH=4, D=8):
    """A packed mixed batch: row 0 decodes (1 token at position 8), row 1
    is a cold prefill of 6 tokens, row 2 a warm suffix of 3 tokens at
    q_start 5, then two pad slots. The block tables come from the port's
    manager."""
    rng = np.random.RandomState(seed)
    mgr = tpa.PagedKVCacheManager(1, NPAGES, PAGE, NKV, D,
                                  dtype=torch.float32, device="cpu")
    k_pool = rng.randn(NPAGES, PAGE, NKV, D).astype(np.float32)
    v_pool = rng.randn(NPAGES, PAGE, NKV, D).astype(np.float32)
    kv_lens = [9, 6, 8]
    for sid, n in enumerate(kv_lens):
        mgr.allocate(sid, n)
    bt, _ = mgr.block_tables([0, 1, 2])
    token_row = np.array([0] + [1] * 6 + [2] * 3 + [-1, -1], np.int32)
    positions = np.array([8] + list(range(6)) + [5, 6, 7] + [0, 0],
                         np.int32)
    q = rng.randn(len(token_row), NH, D).astype(np.float32)
    return (q, k_pool, v_pool, bt.astype(np.int32), token_row, positions,
            np.asarray(kv_lens, np.int32))


def _torch(args, dtype=torch.float32):
    q, kp, vp, *meta = args
    return ([torch.from_numpy(a).to(dtype) for a in (q, kp, vp)]
            + [torch.from_numpy(a) for a in meta])


def _jax(args, dtype=jnp.float32):
    q, kp, vp, *meta = args
    return ([jnp.asarray(a, dtype) for a in (q, kp, vp)]
            + [jnp.asarray(a) for a in meta])


SHAPES = [dict(NKV=2, NH=4, D=8), dict(NKV=4, NH=4, D=16),
          dict(NKV=2, NH=8, D=16)]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "nh{NH}_nkv{NKV}_d{D}"
                         .format(**s))
def test_plain_matches_jax_array_reference(seed, shape):
    args = _mixed_batch(seed=seed, **shape)
    want = np.asarray(jpa.ragged_paged_attention_array(*_jax(args)))
    got = tpa.ragged_paged_attention(*_torch(args)).numpy()
    real = args[4] >= 0
    # the JAX array path leaves pad rows at a masked-uniform average; the
    # port zeroes them like both kernels, so compare the real rows here
    np.testing.assert_allclose(got[real], want[real], **FP32)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "nh{NH}_nkv{NKV}_d{D}"
                         .format(**s))
def test_plain_matches_pallas_kernel_interpret(seed, shape):
    """The Pallas kernel the CUDA kernel replaces, pad slots included."""
    args = _mixed_batch(seed=seed, **shape)
    want = np.asarray(jpa.ragged_paged_attention_pallas(*_jax(args),
                                                        interpret=True))
    got = tpa.ragged_paged_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    real = args[4] >= 0
    assert np.all(np.isfinite(got))
    assert np.all(got[~real] == 0.0)


def test_plain_matches_jax_array_reference_bf16():
    """bf16 pools: both sides round the probabilities to bf16 before P·V;
    compared in fp32 at bf16's resolution (8 mantissa bits)."""
    args = _mixed_batch(seed=5, **SHAPES[2])
    want = np.asarray(jpa.ragged_paged_attention_array(
        *_jax(args, jnp.bfloat16)).astype(jnp.float32))
    got = tpa.ragged_paged_attention(*_torch(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    real = args[4] >= 0
    np.testing.assert_allclose(got.float().numpy()[real], want[real],
                               rtol=0, atol=2e-2)


def test_scale_argument_matches_jax():
    args = _mixed_batch(seed=4)
    want = np.asarray(jpa.ragged_paged_attention_pallas(
        *_jax(args), scale=0.5, interpret=True))
    got = tpa.ragged_paged_attention(*_torch(args), scale=0.5).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_cpu_tensors_count_no_launch_and_kernel_refuses_cpu():
    args = _torch(_mixed_batch(seed=1))
    before = tpa.ragged_paged_attention.launches
    tpa.ragged_paged_attention(*args)
    assert tpa.ragged_paged_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tpa.ragged_paged_attention_kernel(*args)


# ---------------------------------------------------------------------------
# PagedKVCacheManager parity
# ---------------------------------------------------------------------------

def _ops_sequence():
    """allocate / extend / free, with reuse of freed pages."""
    return [("alloc", 0, 9), ("alloc", 1, 4), ("alloc", 2, 13),
            ("extend", 1, 1), ("free", 0, 0), ("alloc", 3, 6),
            ("extend", 2, 7), ("free", 1, 0), ("alloc", 4, 1),
            ("extend", 4, 3), ("alloc", 5, 17)]


def test_manager_matches_jax_manager():
    args = (1, 24, 4, 2, 8)
    jm = jpa.PagedKVCacheManager(*args, dtype=jnp.float32)
    tm = tpa.PagedKVCacheManager(*args, dtype=torch.float32, device="cpu")
    assert tm.usable_pages == jm.usable_pages
    assert tuple(tm.k_pages.shape) == tuple(jm.k_pages.shape)
    live = set()
    for op, sid, n in _ops_sequence():
        if op == "alloc":
            assert tm.allocate(sid, n) == jm.allocate(sid, n)
            live.add(sid)
        elif op == "extend":
            tm.extend(sid, n)
            jm.extend(sid, n)
        else:
            tm.free(sid)
            jm.free(sid)
            live.discard(sid)
        assert tm.num_free_pages == jm.num_free_pages
        ids = sorted(live)
        tbt, tl = tm.block_tables(ids)
        jbt, jl = jm.block_tables(ids)
        np.testing.assert_array_equal(tbt, jbt)
        np.testing.assert_array_equal(tl, jl)
        tm.check_conservation()
        jm.check_conservation()


@pytest.mark.parametrize("n", [0, 1, 4, 5, 16, 17])
def test_pages_needed_matches_jax(n):
    assert (tpa.PagedKVCacheManager.pages_needed(n, 4)
            == jpa.PagedKVCacheManager.pages_needed(n, 4))


def test_manager_exhaustion_raises_like_jax():
    tm = tpa.PagedKVCacheManager(1, 4, 4, 1, 8, dtype=torch.float32,
                                 device="cpu")
    tm.allocate("a", 12)
    with pytest.raises(MemoryError):
        tm.allocate("b", 1)
    with pytest.raises(MemoryError):
        tm.extend("a", 1)
    tm.check_conservation()


def test_conservation_audit_catches_double_ownership():
    tm = tpa.PagedKVCacheManager(1, 8, 4, 1, 8, dtype=torch.float32,
                                 device="cpu")
    tm.allocate("a", 4)
    tm.allocate("b", 4)
    tm.check_conservation()
    # corrupt the books: b's table now aliases a's page
    tm._tables["b"][0] = tm._tables["a"][0]
    with pytest.raises(RuntimeError, match="owned by two"):
        tm.check_conservation()
