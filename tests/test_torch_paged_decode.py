"""The legacy pipeline's attention ops: the PyTorch port's one-query paged
decode (``paged_attention``), its K/V scatter (``paged_write``) and its
suffix prefill attention (``paged_prefill_attention_plain``) against the
JAX package — the XLA array paths and the Pallas decode kernel in
interpret mode — on the same numpy inputs. On the CPU the port runs the
plain versions; the CUDA kernel is held against the plain version on
the card (tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# the JAX package's own tolerance for the decode kernel against its array
# path (tests/test_paged_attention.py): fp32, sums in another order
FP32 = dict(rtol=1e-5, atol=1e-6)


def _decode_batch(seed=0, lens=(7, 13, 1, 16, 5), PAGE=4, NPAGES=40,
                  NKV=2, NH=4, D=8, seq_lens=None):
    """Rows of ragged lengths over pages from the port's manager; pool
    contents are random everywhere (stale data past each row's length
    must not leak into its output). ``seq_lens`` overrides the lengths
    the rows attend (``lens`` still sizes their pages)."""
    rng = np.random.RandomState(seed)
    mgr = tpa.PagedKVCacheManager(1, NPAGES, PAGE, NKV, D,
                                  dtype=torch.float32, device="cpu")
    for sid, n in enumerate(lens):
        mgr.allocate(sid, max(n, 1))
    bt, _ = mgr.block_tables(list(range(len(lens))))
    k_pool = rng.randn(NPAGES, PAGE, NKV, D).astype(np.float32)
    v_pool = rng.randn(NPAGES, PAGE, NKV, D).astype(np.float32)
    q = rng.randn(len(lens), NH, D).astype(np.float32)
    return (q, k_pool, v_pool, bt.astype(np.int32),
            np.asarray(lens if seq_lens is None else seq_lens, np.int32))


def _torch(args, dtype=torch.float32):
    q, kp, vp, *meta = args
    return ([torch.from_numpy(a).to(dtype) for a in (q, kp, vp)]
            + [torch.from_numpy(a) for a in meta])


def _jax(args, dtype=jnp.float32):
    q, kp, vp, *meta = args
    return ([jnp.asarray(a, dtype) for a in (q, kp, vp)]
            + [jnp.asarray(a) for a in meta])


SHAPES = [dict(NKV=2, NH=4, D=8), dict(NKV=4, NH=4, D=16),
          dict(NKV=1, NH=8, D=16), dict(NKV=2, NH=12, D=8)]
_ids = lambda s: "nh{NH}_nkv{NKV}_d{D}".format(**s)  # noqa: E731


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_decode_plain_matches_jax_array_reference(seed, shape):
    """MHA and GQA (groups of 2, 8 and 6 query heads), ragged lengths
    drawn from the seed."""
    lens = np.random.RandomState(seed + 100).randint(1, 30, size=6)
    args = _decode_batch(seed=seed, lens=tuple(lens), **shape)
    want = np.asarray(jpa.paged_attention_array(*_jax(args)))
    got = tpa.paged_attention(*_torch(args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_decode_plain_matches_pallas_kernel_interpret(shape):
    """The Pallas kernel the CUDA kernel replaces, with a row of length 0
    (exactly 0 from both) and a row whose length runs past its table (the
    kernel reads the table's whole span)."""
    args = _decode_batch(seed=11, lens=(7, 0, 13, 1, 16, 9),
                         seq_lens=(7, 0, 13, 1, 16, 60), **shape)
    assert args[3].shape[1] * 4 < 60                   # span 16 keys
    want = np.asarray(jpa.paged_attention_pallas(*_jax(args),
                                                 interpret=True))
    got = tpa.paged_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    assert np.all(got[1] == 0.0) and np.all(want[1] == 0.0)
    assert np.all(np.isfinite(got))


# chunk sizes of the split's plain form over a span of 16 keys (pages of
# 4): one key, a chunk cutting pages, a page, a chunk longer than most
# rows, the span, and more than the span
_CHUNKS = [1, 3, 4, 5, 16, 40]


@pytest.mark.parametrize("chunk", _CHUNKS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_split_then_merge_matches_jax(shape, chunk):
    """The key split's arithmetic (a state per chunk, then the merge)
    against the port's plain version, the JAX array path and the Pallas
    kernel in interpret mode: rows of 0 keys (exactly 0; the array path
    averages there), 1, 7, 13, a page edge and one over-decoded past its
    table's span."""
    args = _decode_batch(seed=12, lens=(7, 0, 13, 1, 16, 9),
                         seq_lens=(7, 0, 13, 1, 16, 60), **shape)
    assert args[3].shape[1] * 4 == 16                  # span 16 keys
    got = tpa.paged_attention_split_plain(*_torch(args), chunk=chunk)
    got = got.numpy()
    np.testing.assert_allclose(got, tpa.paged_attention(*_torch(args)),
                               **FP32)
    pallas = np.asarray(jpa.paged_attention_pallas(*_jax(args),
                                                   interpret=True))
    np.testing.assert_allclose(got, pallas, **FP32)
    array = np.asarray(jpa.paged_attention_array(*_jax(args)))
    keep = [0, 2, 3, 4, 5]          # row 1: the array path averages V
    np.testing.assert_allclose(got[keep], array[keep], **FP32)
    assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("chunk", [1, 4, 7, 64])
def test_split_then_merge_bf16_and_scale(chunk):
    """bf16 pools and a scale argument: the split keeps the probabilities
    in fp32 and rounds only its output, so it sits within one bf16 step of
    the Pallas kernel (interpret mode, fp32 P)."""
    args = _decode_batch(seed=13, lens=(9, 30, 2, 17), **SHAPES[1])
    want = np.asarray(jpa.paged_attention_pallas(
        *_jax(args, jnp.bfloat16), scale=0.3, interpret=True).astype(
            jnp.float32))
    got = tpa.paged_attention_split_plain(*_torch(args, torch.bfloat16),
                                          chunk=chunk, scale=0.3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                               atol=1e-2)


def test_decode_empty_row_is_zero_where_the_array_path_averages():
    """seq_len 0: the port (like the Pallas and CUDA kernels) gives 0;
    the JAX array path gives the mean of the row's gathered V (a softmax
    over all-masked lanes). The other rows agree."""
    args = _decode_batch(seed=2, lens=(5, 0, 9))
    want = np.asarray(jpa.paged_attention_array(*_jax(args)))
    got = tpa.paged_attention(*_torch(args)).numpy()
    assert np.all(got[1] == 0.0) and np.abs(want[1]).max() > 0
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **FP32)


def test_decode_plain_matches_jax_array_reference_bf16():
    """bf16 pools: both sides round the probabilities to bf16 before P·V;
    compared in fp32 at bf16's resolution (8 mantissa bits)."""
    args = _decode_batch(seed=5, lens=(9, 30, 2, 17), **SHAPES[2])
    want = np.asarray(jpa.paged_attention_array(
        *_jax(args, jnp.bfloat16)).astype(jnp.float32))
    got = tpa.paged_attention(*_torch(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)


def test_decode_scale_argument_matches_jax():
    args = _decode_batch(seed=4)
    want = np.asarray(jpa.paged_attention_pallas(*_jax(args), scale=0.5,
                                                 interpret=True))
    got = tpa.paged_attention(*_torch(args), scale=0.5).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_cpu_tensors_count_no_launch_and_kernel_refuses_cpu():
    args = _torch(_decode_batch(seed=1))
    before = tpa.paged_attention.launches
    tpa.paged_attention(*args)
    assert tpa.paged_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_kernel(*args)


# ---------------------------------------------------------------------------
# paged_write and the suffix prefill attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_paged_write_matches_jax(seed):
    """One token per row into its page slot: rows at page starts, page
    ends and mid-page, and one row past its allocated pages (its table
    slot is 0, the pad page). Pools updated in place."""
    rng = np.random.RandomState(seed)
    P, PAGE, NKV, D = 12, 4, 2, 8
    mgr = tpa.PagedKVCacheManager(1, P, PAGE, NKV, D, dtype=torch.float32,
                                  device="cpu")
    for sid, n in enumerate((9, 4, 6, 3)):
        mgr.allocate(sid, n)
    bt, _ = mgr.block_tables([0, 1, 2, 3])
    positions = np.array([8, 3, 4, 5], np.int32)      # row 3: past its page
    kp = rng.randn(P, PAGE, NKV, D).astype(np.float32)
    vp = rng.randn(P, PAGE, NKV, D).astype(np.float32)
    kn = rng.randn(4, NKV, D).astype(np.float32)
    vn = rng.randn(4, NKV, D).astype(np.float32)
    jk, jv = jpa.paged_write_array(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(bt), jnp.asarray(positions))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tpa.paged_write(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.from_numpy(bt), torch.from_numpy(positions))
    assert out[0] is tk and out[1] is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_write_past_the_table_goes_to_page_zero():
    """A position at or past W·page (a finished row over-decoding to the
    end of a legacy decode chunk): JAX drops the write; the port sends it
    to the pad page 0, and every other page equals JAX's — in particular
    the row's last real slot is untouched."""
    rng = np.random.RandomState(3)
    P, PAGE, NKV, D = 8, 4, 1, 8
    bt = np.array([[1, 2], [3, 4]], np.int32)          # span 8
    positions = np.array([8, 11], np.int32)
    kp = rng.randn(P, PAGE, NKV, D).astype(np.float32)
    kn = rng.randn(2, NKV, D).astype(np.float32)
    jk, _ = jpa.paged_write_array(jnp.asarray(kp), jnp.asarray(kp),
                                  jnp.asarray(kn), jnp.asarray(kn),
                                  jnp.asarray(bt), jnp.asarray(positions))
    tk = torch.from_numpy(kp.copy())
    tpa.paged_write(tk, tk.clone(), torch.from_numpy(kn),
                    torch.from_numpy(kn), torch.from_numpy(bt),
                    torch.from_numpy(positions))
    np.testing.assert_array_equal(np.asarray(jk), kp)  # JAX: dropped
    np.testing.assert_array_equal(tk.numpy()[1:], kp[1:])
    np.testing.assert_array_equal(tk.numpy()[0, 0], kn[0])
    np.testing.assert_array_equal(tk.numpy()[0, 3], kn[1])


@pytest.mark.parametrize("shape", SHAPES[:3], ids=_ids)
def test_paged_prefill_attention_plain_matches_jax(shape):
    """Suffix queries at offsets (a cold row at 0, warm rows at 5 and 8,
    a pad row) over the gathered page span, key_pos <= q_start + t."""
    rng = np.random.RandomState(6)
    PAGE, NPAGES = 4, 32
    nh, nkv, d = shape["NH"], shape["NKV"], shape["D"]
    mgr = tpa.PagedKVCacheManager(1, NPAGES, PAGE, nkv, d,
                                  dtype=torch.float32, device="cpu")
    for sid, n in enumerate((6, 11, 14, 1)):
        mgr.allocate(sid, n)
    bt, _ = mgr.block_tables([0, 1, 2, 3])
    q_start = np.array([0, 5, 8, 0], np.int32)
    kp = rng.randn(NPAGES, PAGE, nkv, d).astype(np.float32)
    vp = rng.randn(NPAGES, PAGE, nkv, d).astype(np.float32)
    q = rng.randn(4, 6, nh, d).astype(np.float32)
    want = np.asarray(jpa.paged_prefill_attention_array(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(q_start)))
    got = tpa.paged_prefill_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt.astype(np.int32)), torch.from_numpy(q_start))
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_can_allocate_matches_jax():
    args = (1, 6, 4, 1, 2)
    jm = jpa.PagedKVCacheManager(*args, dtype=jnp.float32)
    tm = tpa.PagedKVCacheManager(*args, dtype=torch.float32, device="cpu")
    for m in (jm, tm):
        m.allocate("x", 12)
    for n in (0, 4, 5, 8, 9):
        assert tm.can_allocate(n) == jm.can_allocate(n)
    assert tm.sequence_pages("x") == jm.sequence_pages("x")
