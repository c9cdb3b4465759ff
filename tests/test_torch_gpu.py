"""Card-only tests of the PyTorch/CUDA port: each kernel against its
plain PyTorch version at Llama-2-7B and BERT-large widths, the wrappers'
argument checks, the serving engine, the Llama and ERNIE training steps
and main-grad training of the imperative Llama on the card against the
same on the CPU, and the training steps' launch counts. Marked ``gpu``; they skip where no CUDA device is
present. Run on the card (the machine there has no JAX, so skip the
conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Whether a card exists is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.fleet import meta_optimizers as MO
from paddle_tpu_torch.distributed.fleet.utils import (
    mix_precision_utils as MPU)
from paddle_tpu_torch.inference import decoding as D
from paddle_tpu_torch.models import ernie as E
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_linear as fl
from paddle_tpu_torch.ops import layer_norm_fused as ln
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import rms_norm as rn
from paddle_tpu_torch.optimizer.adamw import AdamW
from paddle_tpu_torch.testing import (LN_TOL, LSE_TOL, MAIN_GRAD_PARITY_TOL,
                                      flash_close, grad_add_close, l2_close,
                                      rms_close, trained_weights_close)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    # fp32 comparisons are full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# bf16 output: one rounding step (8 mantissa bits); fp32: sum order only
_RMS_TOL = {torch.bfloat16: (1.6e-2, 1e-5), torch.float32: (1e-5, 1e-6)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(256, 4096), (1, 37, 4096), (5, 4000)])
def test_rms_norm_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen,
                               device=cuda)).to(dtype)
    before = rn.rms_norm.launches
    got = rn.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rn.rms_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    rtol, atol = _RMS_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               rn.rms_norm_plain(x, w, 1e-5).float(),
                               rtol=rtol, atol=atol)


def test_rms_norm_kernel_rejects_bad_input(cuda):
    x = torch.randn(8, 256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rms_norm(x.t(), torch.ones(8, device=cuda))
    with pytest.raises(TypeError):
        rn.rms_norm(x.double(), torch.ones(256, device=cuda).double())
    with pytest.raises(ValueError):
        rn.rms_norm(x, torch.ones(128, device=cuda))


def _mixed_batch(cuda, dtype, nh, nkv, d=128, page=16, width=8,
                 rows=((99, 1), (40, 1), (0, 30), (64, 17)), scatter=False):
    """Decode rows, a cold and a warm prefill row, an idle row, pads;
    ``scatter`` shuffles the token axis (runs break into short ones)."""
    rng = np.random.RandomState(1)
    n_rows = len(rows) + 1
    n_pages = n_rows * width + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((n_rows, width), np.int32)
    kv_lens = np.zeros((n_rows,), np.int32)
    tr, pos = [], []
    used = 0
    for r, (p0, n) in enumerate(rows):
        kv_lens[r] = p0 + n
        npg = -(-int(kv_lens[r]) // page)
        bt[r, :npg] = perm[used:used + npg]
        used += npg
        tr += [r] * n
        pos += list(range(p0, p0 + n))
    tr += [-1] * 3
    pos += [0] * 3
    tr, pos = np.asarray(tr, np.int32), np.asarray(pos, np.int32)
    if scatter:
        order = rng.permutation(len(tr))
        tr, pos = tr[order], pos[order]
    gen = torch.Generator(device=cuda).manual_seed(2)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    v = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    q = torch.randn((len(tr), nh, d), generator=gen, device=cuda).to(dtype)
    meta = [torch.as_tensor(np.asarray(a, np.int32), device=cuda)
            for a in (bt, tr, pos, kv_lens)]
    return (q, k, v, *meta)


# fp32: summation order and online vs two-pass softmax. bf16/fp16: the
# plain version rounds the probabilities to the pool dtype before P·V (the
# JAX array path's rounding), as the wgmma route does; the key split
# keeps them in fp32 (the Pallas kernel's)
_ATTN_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-5)}
# long rows: prefill runs of 150 and 70 tokens (several tiles, several
# 64-key tiles each, a last page cut by kv_len) beside decode rows
_LONG_ROWS = ((300, 1), (40, 1), (0, 150), (200, 70), (5, 2))


def _check_ragged(args, got, route):
    want = pa.ragged_paged_attention_plain(*args)
    rtol, atol = _ATTN_TOL.get(args[0].dtype, (2e-2, 2e-2))
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{route}: {m}")
    pads = args[4] < 0
    assert bool((got[pads] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("nh,nkv,d", [(32, 32, 128), (32, 8, 128),
                                      (8, 2, 64)])
@pytest.mark.parametrize("page,width,rows,scatter", [
    (16, 8, None, False), (16, 24, _LONG_ROWS, False),
    (16, 24, _LONG_ROWS, True), (8, 48, _LONG_ROWS, False),
    (12, 32, _LONG_ROWS, False)],
    ids=["page16", "page16-long", "page16-scattered", "page8-long",
         "page12-long"])
def test_ragged_attention_kernel_matches_plain(cuda, dtype, nh, nkv, d,
                                               page, width, rows, scatter):
    """Every route against the plain version: the call's own routes
    (wgmma tiles and the key split where ragged_route says so; page 12
    and fp32 take the key split alone) and the key split forced for
    every token; the kernels' tile map equals ``ragged_tiles``."""
    kw = {} if rows is None else dict(rows=rows)
    args = _mixed_batch(cuda, dtype, nh, nkv, d, page=page, width=width,
                        scatter=scatter, **kw)
    routes = pa.ragged_route(dtype, page, nh, nkv)
    before = dict(pa.ragged_paged_attention.route_launches)
    calls = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == calls + 1
    for r in pa.RAGGED_ROUTES:
        assert pa.ragged_paged_attention.route_launches[r] == before[r] + (
            r in routes)
    _, n_chunks = pa.ragged_split(args[0].shape[0], args[3].shape[0],
                                  args[3].shape[1] * page, nh, nkv, d, dtype,
                                  cuda)
    assert pa.ragged_paged_attention.route_launches["merge"] == (
        before["merge"] + (n_chunks > 1))
    _check_ragged(args, got, "+".join(routes))
    ts = pa.ragged_tile_size(dtype, page, nh, nkv)
    tile_map = torch.full((args[0].shape[0],), -7, dtype=torch.int32,
                          device=cuda)
    pa.ragged_paged_attention_kernel(*args, tile_map=tile_map)
    n_rows = args[3].shape[0]
    torch.testing.assert_close(tile_map, pa.ragged_tiles(args[4], n_rows,
                                                         ts))
    split = pa.ragged_paged_attention_kernel(*args, route="key_split")
    torch.cuda.synchronize()
    _check_ragged(args, split, "key_split")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk", [5, 16, 64, 384])
def test_ragged_key_split_chunks_match_plain(cuda, dtype, chunk):
    """The single-token tiles (decode rows of 301, 41, 6 keys) and pad
    slots at forced chunk sizes: a chunk that cuts a page, a page, the
    default's size and the whole span (no merge); the kernels' tile map
    still equals ``ragged_tiles``."""
    args = _mixed_batch(cuda, dtype, 32, 8, 128, width=24, rows=_LONG_ROWS)
    page, nh, nkv = 16, 32, 8
    before = pa.ragged_paged_attention.route_launches["merge"]
    tile_map = torch.full((args[0].shape[0],), -7, dtype=torch.int32,
                          device=cuda)
    for route in (None, "key_split"):
        got = pa.ragged_paged_attention_kernel(*args, route=route,
                                               tile_map=tile_map,
                                               chunk=chunk)
        torch.cuda.synchronize()
        _check_ragged(args, got, f"{route} chunk {chunk}")
        ts = (pa.ragged_tile_size(dtype, page, nh, nkv) if route is None
              else 1)
        torch.testing.assert_close(
            tile_map, pa.ragged_tiles(args[4], args[3].shape[0], ts))
    merges = pa.ragged_paged_attention.route_launches["merge"] - before
    assert merges == (2 if chunk < 24 * page else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_attention_kernels_repeat_bitwise(cuda, dtype):
    args = _mixed_batch(cuda, dtype, 32, 8, 128, width=24, rows=_LONG_ROWS)
    for route in (None, "key_split"):
        a = pa.ragged_paged_attention_kernel(*args, route=route)
        b = pa.ragged_paged_attention_kernel(*args, route=route)
        torch.cuda.synchronize()
        assert torch.equal(a, b), route


def test_ragged_attention_row_with_nothing_to_attend_is_zero(cuda):
    """The tokens of a row whose kv_len is 0 attend nothing (the page
    skip leaves no key) and come out exactly 0 on both routes; the other
    rows still match the plain version, which takes no page skip."""
    q, k, v, bt, tr, pos, kvl = _mixed_batch(cuda, torch.bfloat16, 32, 32,
                                             128, width=24, rows=_LONG_ROWS)
    kvl = kvl.clone()
    kvl[2] = 0                       # the 150-token prefill row
    want = pa.ragged_paged_attention_plain(q, k, v, bt, tr, pos, kvl)
    for route in (None, "key_split"):
        got = pa.ragged_paged_attention_kernel(q, k, v, bt, tr, pos, kvl,
                                               route=route)
        torch.cuda.synchronize()
        assert bool((got[tr == 2] == 0).all()), route
        torch.testing.assert_close(got[tr != 2].float(),
                                   want[tr != 2].float(), rtol=2e-2,
                                   atol=2e-2)


def test_ragged_attention_kernel_rejects_bad_input(cuda):
    q, k, v, bt, tr, pos, kvl = _mixed_batch(cuda, torch.float32, 4, 4,
                                             d=128)
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q.half(), k, v, bt, tr, pos, kvl)
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q, k, v, bt, tr, pos.long(), kvl)
    with pytest.raises(ValueError, match="head_dim"):
        pa.ragged_paged_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  v[..., :96].contiguous(), bt, tr, pos, kvl)
    with pytest.raises(ValueError, match="route"):
        pa.ragged_paged_attention_kernel(q, k, v, bt, tr, pos, kvl,
                                         route="wgmma")   # fp32 pools


def test_ragged_step_launch_counts(cuda):
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=3)
    eng = D.ContinuousBatchingEngine(cfg, D.GenerationConfig(
        max_new_tokens=3), num_slots=2, page_size=16, max_seq_len=64,
        chunk=2, device=cuda)
    params = L.init_params(cfg, seed=0, device=cuda)
    rn.rms_norm.launches = 0
    pa.ragged_paged_attention.launches = 0
    eng.serve(params, [np.arange(1, 9, dtype=np.int32)])
    n = eng.micro_rounds
    assert n > 0
    assert rn.rms_norm.launches == (2 * 3 + 1) * n
    assert pa.ragged_paged_attention.launches == 3 * n


def test_engine_on_card_matches_cpu(cuda):
    """fp32 greedy tokens: kernels on the card == plain versions on the
    CPU, for MHA and GQA at head_dim 128."""
    for nkv in (4, 2):
        cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=nkv, intermediate_size=512,
                           num_hidden_layers=2)
        params = L.init_params(cfg, seed=1, device="cpu")
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (4, 33, 18, 2)]
        outs = []
        for dev in (cuda, "cpu"):
            eng = D.ContinuousBatchingEngine(
                cfg, D.GenerationConfig(max_new_tokens=6), num_slots=2,
                page_size=16, max_seq_len=96, chunk=3, device=dev)
            outs.append(eng.serve({k: t.to(dev) for k, t in params.items()},
                                  prompts))
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# legacy serving slice: the paged decode kernel, the legacy engine, the cache
# ---------------------------------------------------------------------------

def _decode_batch(cuda, dtype, nh, nkv, d=128, page=16, width=8):
    """Rows of 1, a page edge (16, 17), long, 0 (exactly 0 out) and one
    whose length runs past its table (the kernel reads the whole span)."""
    rng = np.random.RandomState(3)
    seq_lens = np.array([1, 16, 17, 100, 0, 128 + 9], np.int32)
    b = len(seq_lens)
    n_pages = b * width + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, width), np.int32)
    for r, n in enumerate(np.minimum(seq_lens, width * page)):
        npg = -(-int(n) // page)
        bt[r, :npg] = perm[r * width:r * width + npg]
    gen = torch.Generator(device=cuda).manual_seed(4)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    v = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    q = torch.randn((b, nh, d), generator=gen, device=cuda).to(dtype)
    return (q, k, v, torch.as_tensor(bt, device=cuda),
            torch.as_tensor(seq_lens, device=cuda))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("nh,nkv,d", [(32, 32, 128), (32, 8, 128),
                                      (8, 2, 64), (12, 4, 64), (16, 2, 128)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, nh, nkv, d):
    """Groups of 1, 4, 3 (one query head a block) and 8 (two blocks per
    kv head) query heads, at the paged attention tolerances above."""
    args = _decode_batch(cuda, dtype, nh, nkv, d)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_plain(*args)
    rtol, atol = _ATTN_TOL.get(dtype, (2e-2, 2e-2))
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert bool((got[4] == 0).all())


def _split_batch(cuda, dtype, nh, nkv, d, chunk, page=16, width=32):
    """Rows of 0, 1, a page edge (16, 17), one chunk exactly, one chunk
    + 1, the span, and one over-decoded past the span."""
    span = width * page
    lens = sorted({0, 1, 16, 17, min(chunk, span), min(chunk + 1, span),
                   span})
    seq_lens = np.asarray(lens + [span + 9], np.int32)
    b = len(seq_lens)
    rng = np.random.RandomState(5)
    n_pages = b * width + 1
    bt = rng.permutation(np.arange(1, n_pages))[:b * width].reshape(
        b, width).astype(np.int32)
    gen = torch.Generator(device=cuda).manual_seed(6)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    v = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    q = torch.randn((b, nh, d), generator=gen, device=cuda).to(dtype)
    return (q, k, v, torch.as_tensor(bt, device=cuda),
            torch.as_tensor(seq_lens, device=cuda))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("nh,nkv,d", [(8, 8, 128), (16, 8, 64), (32, 8, 128),
                                      (16, 2, 64)],
                         ids=["group1", "group2", "group4", "group8"])
@pytest.mark.parametrize("chunk", [None, 16, 64, 200, 512])
def test_paged_decode_split_matches_plain(cuda, dtype, nh, nkv, d, chunk):
    """The key split at decode_split's chunk and forced ones (a page, a
    step of 64 keys, 200 keys cutting pages, the whole span: one chunk,
    no merge) against the plain version, over lengths 0 (exactly 0), 1, a
    page edge, one chunk, one chunk + 1, the span and past it; one call,
    one key-split launch and a merge where the span takes more than one
    chunk."""
    args = _split_batch(cuda, dtype, nh, nkv, d, chunk or pa.paged_split(
        8, 512, nh, nkv, d, dtype, cuda)[0])
    c, n_chunks = (pa.paged_split(args[0].shape[0], 512, nh, nkv, d, dtype,
                                  cuda)
                   if chunk is None else (chunk, -(-512 // chunk)))
    before = (pa.paged_attention.launches,
              dict(pa.paged_attention.route_launches))
    got = pa.paged_attention_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before[0] + 1
    assert pa.paged_attention.route_launches == {
        "key_split": before[1]["key_split"] + 1,
        "merge": before[1]["merge"] + (n_chunks > 1)}
    want = pa.paged_attention_plain(*args)
    rtol, atol = _ATTN_TOL.get(dtype, (2e-2, 2e-2))
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert bool((got[0] == 0).all())
    # the split's own arithmetic, P in fp32 on both sides
    split = pa.paged_attention_split_plain(*args, chunk=c)
    torch.testing.assert_close(got.float(), split.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_repeats_bitwise(cuda, dtype):
    args = _split_batch(cuda, dtype, 32, 8, 128, 64)
    for chunk in (None, 16):
        a = pa.paged_attention_kernel(*args, chunk=chunk)
        b = pa.paged_attention_kernel(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(a, b), chunk


def test_paged_decode_kernel_rejects_bad_input(cuda):
    q, k, v, bt, sl = _decode_batch(cuda, torch.float32, 4, 4, d=128)
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), k, v, bt, sl)
    with pytest.raises(TypeError):
        pa.paged_attention(q, k, v, bt, sl.long())
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                           v[..., :96].contiguous(), bt, sl)
    with pytest.raises(ValueError, match="rows"):
        pa.paged_attention(q, k, v, bt[:2], sl)


def test_decode_step_paged_launch_counts(cuda):
    """A legacy serve: the paged decode kernel L times per decode step,
    the flash forward L times per cold prefill wave, RMSNorm 2L+1 times
    per prefill wave or decode step."""
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=3)
    eng = D.ContinuousBatchingEngine(cfg, D.GenerationConfig(
        max_new_tokens=3), num_slots=2, page_size=16, max_seq_len=64,
        chunk=2, device=cuda, unified=False)
    params = L.init_params(cfg, seed=0, device=cuda)
    counters = (rn.rms_norm, pa.paged_attention, fa.flash_fwd_kernel,
                pa.ragged_paged_attention)
    for c in counters:
        c.launches = 0
    eng.serve(params, [np.arange(1, 9, dtype=np.int32),
                       np.arange(3, 30, dtype=np.int32)])
    steps, waves = eng.decode_steps, eng.prefill_calls
    assert steps > 0 and waves > 0
    assert rn.rms_norm.launches == 7 * (steps + waves)
    assert pa.paged_attention.launches == 3 * steps
    assert fa.flash_fwd_kernel.launches == 3 * waves
    assert pa.ragged_paged_attention.launches == 0


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_legacy_engine_on_card_matches_cpu(cuda, prefix_cache):
    """fp32 greedy tokens of the legacy pipeline (and, with the cache, a
    shared-prefix wave and an exact repeat for COW): kernels on the card
    == plain versions on the CPU, MHA and GQA at head_dim 128."""
    for nkv in (4, 2):
        cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=nkv, intermediate_size=512,
                           num_hidden_layers=2)
        params = L.init_params(cfg, seed=1, device="cpu")
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (4, 33, 18, 2, 32)]
        prompts += [np.concatenate([prompts[1][:20], prompts[0]]),
                    prompts[4].copy()]
        outs = []
        for dev in (cuda, "cpu"):
            eng = D.ContinuousBatchingEngine(
                cfg, D.GenerationConfig(max_new_tokens=6), num_slots=2,
                page_size=16, max_seq_len=96, chunk=4, device=dev,
                unified=False, prefix_cache=prefix_cache)
            outs.append(eng.serve({k: t.to(dev) for k, t in params.items()},
                                  prompts))
            if prefix_cache:
                assert eng.cache.snapshot()["cow_copies"] >= 1
        assert outs[0] == outs[1]


def test_paged_generation_engine_on_card_matches_cpu(cuda):
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=1, intermediate_size=512,
                       num_hidden_layers=2)
    params = L.init_params(cfg, seed=2, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 17, 40)]
    outs = [D.PagedGenerationEngine(cfg, D.GenerationConfig(
        max_new_tokens=7), page_size=16, device=dev).generate(
            {k: t.to(dev) for k, t in params.items()}, prompts)
        for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# training slice: RMSNorm backward, flash attention, the train step
# ---------------------------------------------------------------------------

# dx: one rounding of an fp32 value (bf16: 8 mantissa bits); dw: a sum
# over rows in another order before its one rounding
_RMS_BWD_TOL = {torch.bfloat16: dict(dx=(1.6e-2, 1e-4), dw=(1.6e-2, 1e-2)),
                torch.float32: dict(dx=(1e-5, 1e-5), dw=(1e-5, 1e-4))}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1024, 4096), (1, 37, 4096), (5, 4000),
                                   (600, 256)])
def test_rms_norm_bwd_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen,
                               device=cuda)).to(dtype)
    before = rn.rms_norm_bwd.launches
    dx, dw = rn.rms_norm_bwd(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert rn.rms_norm_bwd.launches == before + 1
    assert dx.dtype == dtype and dw.dtype == dtype and dx.shape == x.shape
    pdx, pdw = rn.rms_norm_bwd_plain(x, w, g, 1e-5)
    for name, got, want in (("dx", dx, pdx), ("dw", dw, pdw)):
        rtol, atol = _RMS_BWD_TOL[dtype][name]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=name)


def test_rms_norm_autograd_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 5, 512).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.randn(512)).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 5, 512).astype(np.float32))
    grads = []
    for dev in (cuda, "cpu"):
        xt = x.to(dev).requires_grad_(True)
        wt = w.to(dev).requires_grad_(True)
        rn.rms_norm(xt, wt, 1e-5).backward(g.to(dev))
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rms_norm_bwd_kernel_rejects_bad_input(cuda):
    x = torch.randn(8, 256, device=cuda)
    w = torch.ones(256, device=cuda)
    with pytest.raises(TypeError):
        rn.rms_norm_bwd(x, w, x.bfloat16())
    with pytest.raises(ValueError):
        rn.rms_norm_bwd(x, w, x[:4])
    with pytest.raises(ValueError, match="contiguous"):
        rn.rms_norm_bwd(x, w, torch.randn(256, 8, device=cuda).t())


# flash tensors are held per tensor to paddle_tpu_torch.testing.FLASH_TOL
# (bh, sq, sk, d, causal, kv_rep, kv_valid); the bf16 kernels' tiles are
# 64 rows a warpgroup, 128 a block, 64 or 128 keys, so S runs over one
# row, tile - 1 and tile + 1 at both sizes, and a long 2000
_FLASH_CASES = [(8, 300, 300, 128, True, 1, None),
                (8, 256, 256, 128, True, 4, None),
                (4, 256, 256, 128, True, 1, 200),
                (4, 130, 130, 128, False, 2, None),
                (4, 64, 200, 128, True, 1, None),
                (6, 200, 200, 64, True, 3, None),
                (4, 1, 130, 128, True, 1, None),
                (4, 1, 130, 64, False, 2, None),
                (4, 63, 63, 64, True, 1, None),
                (4, 65, 65, 128, True, 1, None),
                (4, 127, 127, 128, False, 1, 100),
                (4, 129, 129, 64, True, 1, None),
                (2, 2000, 2000, 128, True, 1, None),
                (8, 300, 300, 64, True, 4, None),
                (8, 300, 300, 128, False, 4, 250)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", _FLASH_CASES,
                         ids=lambda c: "bh{}_sq{}_sk{}_d{}_c{}_rep{}_kv{}"
                         .format(*c))
def test_flash_kernels_match_plain(cuda, dtype, case):
    bh, sq, sk, d, causal, rep, kv_valid = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((bh, sq, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((bh // rep, sk, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((bh // rep, sk, d), generator=gen, device=cuda).to(dtype)
    do = torch.randn((bh, sq, d), generator=gen, device=cuda).to(dtype)
    off = sk - sq if causal and sq != sk else 0
    args = (d ** -0.5, causal, kv_valid, off, rep)
    counts = [fa.flash_fwd_kernel.launches, fa.flash_bwd_dq_kernel.launches,
              fa.flash_bwd_dkv_kernel.launches]
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    torch.cuda.synchronize()
    assert [fa.flash_fwd_kernel.launches, fa.flash_bwd_dq_kernel.launches,
            fa.flash_bwd_dkv_kernel.launches] == [c + 1 for c in counts]
    pout, plse = fa.flash_fwd_plain(q, k, v, *args)
    grads = fa.flash_bwd_plain(q, k, v, out, lse, do, *args)
    flash_close(out, pout, dtype, "out")
    torch.testing.assert_close(lse, plse, rtol=LSE_TOL[0], atol=LSE_TOL[1])
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert torch.isfinite(got.float()).all(), name
        flash_close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offset", [-10, -70])
def test_flash_kernels_with_negative_causal_offset(cuda, dtype, d, offset):
    """causal_offset < 0: the first -offset rows attend no key (out 0,
    lse -1e30, zero gradients), and 70 covers a whole 64-row tile."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (torch.randn((4, 200, d), generator=gen,
                               device=cuda).to(dtype) for _ in range(4))
    args = (d ** -0.5, True, None, offset, 1)
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    torch.cuda.synchronize()
    assert bool((out[:, :-offset] == 0).all())
    assert bool((lse[:, :-offset] == -1e30).all())
    assert bool((dq[:, :-offset] == 0).all())
    pout, plse = fa.flash_fwd_plain(q, k, v, *args)
    flash_close(out, pout, dtype, "out")
    torch.testing.assert_close(lse, plse, rtol=LSE_TOL[0], atol=LSE_TOL[1])
    grads = fa.flash_bwd_plain(q, k, v, out, lse, do, *args)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        flash_close(got, want, dtype, name)


@pytest.mark.parametrize("segments", [False, True])
def test_flash_kernels_repeat_bitwise(cuda, segments):
    """No atomics: every sum has one order, so two runs of the bf16
    kernels give the same bits in out, lse, dq, dk and dv."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    d, s = (64, 512) if segments else (128, 1000)
    q, k, v, do = (torch.randn((8, s, d), generator=gen,
                               device=cuda).bfloat16() for _ in range(4))
    k, v = k[:4].contiguous(), v[:4].contiguous()
    seg = None, None
    if segments:
        ids = torch.from_numpy(_packed_segments(2, s, seed=3)).to(cuda)
        seg = torch.where(ids < 0, -1, ids), torch.where(ids < 0, -2, ids)
    args = (d ** -0.5, not segments, None, 0, 2) + seg
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        runs.append((out, lse) + fa.flash_attention_bwd(q, k, v, out, lse,
                                                        do, *args))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


def test_flash_row_with_no_key_is_zero(cuda):
    q = torch.randn(2, 64, 128, device=cuda)
    out, lse = fa.flash_fwd_kernel(q, q, q, 0.1, True, causal_offset=-10)
    torch.cuda.synchronize()
    assert bool((out[:, :10] == 0).all()) and bool((lse[:, :10] == -1e30).all())
    assert torch.isfinite(out).all()


def test_flash_kernels_reject_bad_input(cuda):
    q = torch.randn(4, 64, 128, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_fwd_kernel(q.half(), q.half(), q.half(), 0.1, True)
    with pytest.raises(TypeError):
        fa.flash_fwd_kernel(q, q.bfloat16(), q, 0.1, True)
    with pytest.raises(ValueError, match="head_dim"):
        x = q[..., :96].contiguous()
        fa.flash_fwd_kernel(x, x, x, 0.1, True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_kernel(q.transpose(0, 1), q, q, 0.1, True)
    with pytest.raises(ValueError, match="kv_rep"):
        fa.flash_fwd_kernel(q, q[:3].contiguous(), q[:3].contiguous(), 0.1,
                            True, kv_rep=2)
    with pytest.raises(ValueError, match="empty"):
        fa.flash_fwd_kernel(q, q[:, :0].contiguous(), q[:, :0].contiguous(),
                            0.1, True)
    lse = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="match"):
        fa.flash_bwd_dq_kernel(q, q, q, q[:, :32].contiguous(), lse, lse, 0.1,
                               True)


def _tiny_train_cfg():
    return L.llama_tiny(hidden_size=256, num_attention_heads=2,
                        num_key_value_heads=1, intermediate_size=512,
                        num_hidden_layers=2, dtype=torch.float32)


def test_train_step_on_card_matches_cpu(cuda):
    """fp32, 3 AdamW steps with full remat: kernels on the card against
    the plain versions on the CPU, from the same weights."""
    cfg = _tiny_train_cfg()
    params = L.init_params(cfg, seed=2, device="cpu")
    rng = np.random.RandomState(6)
    ids = rng.randint(0, cfg.vocab_size, (3, 2, 1, 70))
    labels = np.roll(ids, -1, axis=-1)
    runs = []
    for dev in (cuda, "cpu"):
        step, _ = L.build_train_step(cfg, learning_rate=1e-3, device=dev)
        p = {k: v.clone().to(dev) for k, v in params.items()}
        o = L.init_opt_state(p)
        losses = []
        for i in range(3):
            loss, p, o = step(p, o, torch.from_numpy(ids[i]).to(dev),
                              torch.from_numpy(labels[i]).to(dev))
            losses.append(float(loss))
        runs.append((losses, {k: v.cpu() for k, v in p.items()}))
    # losses: fp32 sums in other orders
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-6)
    trained_weights_close(runs[0][1], runs[1][1], lr=1e-3, steps=3)


def test_train_step_launch_counts(cuda):
    cfg = _tiny_train_cfg()
    n = cfg.num_hidden_layers
    step, init = L.build_train_step(cfg, device=cuda)
    params, opt = init(seed=0)
    ids = torch.randint(0, cfg.vocab_size, (2, 1, 64), device=cuda)
    counters = (rn.rms_norm, rn.rms_norm_bwd, fa.flash_fwd_kernel,
                fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel)
    for c in counters:
        c.launches = 0
    loss, params, opt = step(params, opt, ids, ids.roll(-1, dims=-1))
    assert torch.isfinite(loss)
    # two microbatches, each: forward 2L+1 norms and L attentions, the
    # remat replay 2L norms and L attentions, the backward 2L+1 norm
    # backwards and L dQ and dK/dV
    m = 2
    assert [c.launches for c in counters] == [
        m * (4 * n + 1), m * (2 * n + 1), m * 2 * n, m * n, m * n]


# ---------------------------------------------------------------------------
# ERNIE slice: LayerNorm forward/backward, segment ids, the MLM step
# ---------------------------------------------------------------------------

# LayerNorm outputs are held to paddle_tpu_torch.testing.LN_TOL
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8192, 1024), (1, 37, 1024), (5, 1000),
                                   (600, 256), (8192, 768)])
def test_layer_norm_kernels_match_plain(cuda, dtype, shape, eps):
    gen = torch.Generator(device=cuda).manual_seed(7)
    h = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device=cuda) + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(h, generator=gen, device=cuda)).to(dtype)
    before = (ln.layer_norm.launches, ln.layer_norm_bwd.launches)
    y = ln.layer_norm(x, w, b, eps)
    dx, dw, db = ln.layer_norm_bwd(x, w, g, eps)
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.layer_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == dtype and dx.dtype == dtype and dw.dtype == dtype
    tol = LN_TOL[dtype]
    rms_close(y, ln.ln_plain(x, w, b, eps), *tol["y"], "y")
    pdx, pdw, pdb = ln.ln_bwd_plain(x, w, g, eps)
    rms_close(dx, pdx, *tol["dx"], "dx")
    rms_close(dw, pdw, *tol["sums"], "dw")
    rms_close(db, pdb, *tol["sums"], "db")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8192, 1024), (8192, 768), (5, 1000),
                                   (1, 37, 1024), (600, 256)])
def test_layer_norm_bwd_repeats_bitwise_at_every_launch(cuda, dtype, shape):
    """The backward at ln_bwd_config's launch and at the launch it
    replaced (a row a tile, 512 programs of 2 warps): each within LN_TOL
    of ln_bwd_plain, and dw and db the same bits on a second run."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    h = shape[-1]
    rows = int(np.prod(shape[:-1]))
    x = (2 * torch.randn(shape, generator=gen, device=cuda) + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=cuda)).to(dtype)
    tol = LN_TOL[dtype]
    pdx, pdw, pdb = ln.ln_bwd_plain(x, w, g, 1e-12)
    for cfg in (None, ln.LnBwdConfig(1, min(512, rows), 2)):
        dx, dw, db = ln.layer_norm_bwd_kernel(x, w, g, 1e-12, config=cfg)
        _, dw2, db2 = ln.layer_norm_bwd_kernel(x, w, g, 1e-12, config=cfg)
        torch.cuda.synchronize()
        rms_close(dx, pdx, *tol["dx"], f"dx {cfg}")
        rms_close(dw, pdw, *tol["sums"], f"dw {cfg}")
        rms_close(db, pdb, *tol["sums"], f"db {cfg}")
        assert torch.equal(dw, dw2) and torch.equal(db, db2), cfg


def test_layer_norm_autograd_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 5, 512).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.randn(512)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(512)).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 5, 512).astype(np.float32))
    grads = []
    for dev in (cuda, "cpu"):
        ts = [t.to(dev).requires_grad_(True) for t in (x, w, b)]
        ln.layer_norm(*ts, 1e-12).backward(g.to(dev))
        grads.append([t.grad.cpu() for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_layer_norm_kernels_reject_bad_input(cuda):
    x = torch.randn(8, 256, device=cuda)
    w = torch.ones(256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_kernel(x.t(), torch.ones(8, device=cuda),
                             torch.zeros(8, device=cuda))
    with pytest.raises(TypeError):
        ln.layer_norm_kernel(x, w, w.bfloat16())
    with pytest.raises(ValueError):
        ln.layer_norm_kernel(x, w, torch.zeros(128, device=cuda))
    with pytest.raises(TypeError):
        ln.layer_norm_bwd_kernel(x, w, x.bfloat16())


def _packed_segments(rows, s, seed):
    """(rows, s) int32 segment ids: sequences of random lengths packed
    back to back, the last row ending in a long run of pads (-1)."""
    rng = np.random.RandomState(seed)
    seg = np.full((rows, s), -1, np.int32)
    for r in range(rows):
        fill = s // 3 if r == rows - 1 else s - rng.randint(0, s // 8)
        at, i = 0, 0
        while at < fill:
            n = min(int(rng.randint(s // 8, s // 2)), fill - at)
            seg[r, at:at + n] = i
            at, i = at + n, i + 1
    return seg


# (bh, s, d, causal, kv_rep, rows of segment ids; 0 = one shared row):
# segments of s/8 to s/2 cross the 64-position tile edges, and the last
# row's two thirds of pads skip whole tiles
_SEG_CASES = [(8, 300, 64, False, 1, 2), (6, 256, 128, True, 1, 0),
              (16, 512, 64, False, 1, 4), (8, 200, 64, True, 2, 2),
              (16, 1024, 64, False, 1, 4), (16, 512, 128, True, 4, 2),
              (8, 129, 128, False, 1, 8), (4, 700, 64, True, 1, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", _SEG_CASES,
                         ids=lambda c: "bh{}_s{}_d{}_c{}_rep{}_rows{}"
                         .format(*c))
def test_segmented_flash_kernels_match_plain(cuda, dtype, case):
    bh, s, d, causal, rep, rows = case
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((bh, s, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((bh // rep, s, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((bh // rep, s, d), generator=gen, device=cuda).to(dtype)
    do = torch.randn((bh, s, d), generator=gen, device=cuda).to(dtype)
    seg = _packed_segments(max(rows, 1), s, seed=bh + s)
    if rows == 0:
        seg = seg[0]
    seg = torch.from_numpy(seg).to(cuda)
    sq, sk = torch.where(seg < 0, -1, seg), torch.where(seg < 0, -2, seg)
    args = (d ** -0.5, causal, None, 0, rep, sq, sk)
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    torch.cuda.synchronize()
    pout, plse = fa.flash_fwd_plain(q, k, v, *args)
    flash_close(out, pout, dtype, "out")
    torch.testing.assert_close(lse, plse, rtol=LSE_TOL[0], atol=LSE_TOL[1])
    pads = fa._seg_rows(sq, bh).expand(bh, -1) < 0
    assert bool((out[pads] == 0).all()) and bool((lse[pads] == -1e30).all())
    grads = fa.flash_bwd_plain(q, k, v, out, lse, do, *args)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        assert torch.isfinite(got.float()).all(), name
        flash_close(got, want, dtype, name)
    assert bool((dq[pads] == 0).all())


def test_segmented_flash_rejects_bad_segments(cuda):
    q = torch.randn(4, 64, 64, device=cuda)
    seg = torch.zeros(2, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="together"):
        fa.flash_fwd_kernel(q, q, q, 0.1, False, seg_q=seg)
    with pytest.raises(TypeError):
        fa.flash_fwd_kernel(q, q, q, 0.1, False, seg_q=seg.long(),
                            seg_k=seg.long())
    with pytest.raises(ValueError, match="match"):
        half = seg[:, :32].contiguous()
        fa.flash_fwd_kernel(q, q, q, 0.1, False, seg_q=half, seg_k=half)
    with pytest.raises(ValueError, match="match"):
        three = torch.zeros(3, 64, dtype=torch.int32, device=cuda)
        fa.flash_fwd_kernel(q, q, q, 0.1, False, seg_q=three, seg_k=three)


def test_flash_attention_varlen_on_card_matches_cpu(cuda):
    """fp32 packed (total, H, D) attention with one shared row of
    segment ids: the kernels on the card against the plain versions on
    the CPU, forward and backward (FLASH_TOL's fp32 bounds)."""
    rng = np.random.RandomState(11)
    cu = torch.tensor([0, 100, 230, 300])
    q, k, v, g = (torch.from_numpy(rng.randn(300, 4, 64).astype(np.float32))
                  for _ in range(4))
    runs = []
    for dev in (cuda, "cpu"):
        ts = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention_varlen(*ts, cu, cu, causal=True)
        out.backward(g.to(dev))
        runs.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    for name, got, want in zip(("out", "dq", "dk", "dv"), *runs):
        flash_close(got, want, torch.float32, name)


def _tiny_ernie_cfg():
    # d 64 heads: the flash kernels take d 64 and 128
    return E.ernie_tiny(vocab_size=256, hidden_size=128,
                        num_attention_heads=2, intermediate_size=256,
                        num_hidden_layers=2, max_position_embeddings=128)


def _ernie_batch(cfg, b=3, s=100, seed=10):
    seg = _packed_segments(b, s, seed)
    rng = np.random.RandomState(seed)
    ids = np.where(seg >= 0, rng.randint(1, cfg.vocab_size, (b, s)), 0)
    labels = np.where((rng.rand(b, s) < 0.15) & (seg >= 0), ids, -100)
    return [torch.from_numpy(a.astype(t)) for a, t in
            ((ids, np.int64), (labels, np.int64), (seg, np.int32))]


def test_ernie_train_step_on_card_matches_cpu(cuda):
    """fp32, 3 packed MLM steps: the kernels on the card against the
    plain versions on the CPU, from the same weights (as
    test_train_step_on_card_matches_cpu)."""
    cfg = _tiny_ernie_cfg()
    batch = _ernie_batch(cfg)
    runs = []
    for dev in (cuda, "cpu"):
        step, init = E.build_mlm_train_step(cfg, learning_rate=1e-3,
                                            device="cpu")
        model, _ = init(seed=2)
        model.to(dev)
        opt = E.AdamW(model.named_parameters(), learning_rate=1e-3)
        losses = [float(step(model, opt, *(t.to(dev) for t in batch)))
                  for _ in range(3)]
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in model.named_parameters()}))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-6)
    trained_weights_close(runs[0][1], runs[1][1], lr=1e-3, steps=3,
                          hidden=cfg.hidden_size)


def test_ernie_train_step_launch_counts(cuda):
    cfg = _tiny_ernie_cfg()
    n = cfg.num_hidden_layers
    step, init = E.build_mlm_train_step(cfg, dtype=torch.bfloat16,
                                        device=cuda)
    model, opt = init(seed=0)
    counters = (ln.layer_norm, ln.layer_norm_bwd, fa.flash_fwd_kernel,
                fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel)
    for c in counters:
        c.launches = 0
    loss = step(model, opt, *(t.to(cuda) for t in _ernie_batch(cfg)))
    assert torch.isfinite(loss)
    # the embeddings' LN, two post-LNs per layer and the MLM transform's
    # LN, forward and backward; one flash forward, dQ and dK/dV per layer
    assert [c.launches for c in counters] == [2 * n + 2, 2 * n + 2, n, n, n]


# ---------------------------------------------------------------------------
# Main-grad slice: the weight-gradient accumulation kernel, the imperative
# Llama under the main-grad wrappers
# ---------------------------------------------------------------------------

# (rows, din, dout): the Llama-2-7B projections at a (2, 2048) micro-batch,
# an unaligned shape, rows that are not 16-byte aligned (read element by
# element), no rows, and shapes whose tiles fill less than a wave (the
# wgmma route splits their rows, 16 and 4 parts)
_GRAD_ADD_SHAPES = [(4096, 4096, 4096), (4096, 4096, 11008),
                    (4096, 11008, 4096), (1000, 4096, 1000), (37, 13, 29),
                    (0, 64, 48), (8192, 512, 512), (4096, 1024, 1024)]


def _grad_add_inputs(cuda, rows, din, dout, dtype, acc_dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, din, generator=gen, device=cuda).to(dtype)
    g = torch.randn(rows, dout, generator=gen, device=cuda).to(dtype)
    acc = (8 * torch.randn(din, dout, generator=gen, device=cuda)).to(
        acc_dtype)
    return x, g, acc


@pytest.mark.parametrize("shape", _GRAD_ADD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype,acc_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32)],
    ids=["bf16", "fp32", "bf16-acc", "fp16"])
@pytest.mark.parametrize("given", [True, False], ids=["acc", "fresh"])
@pytest.mark.parametrize("route", [None, "wmma"], ids=["auto", "wmma"])
def test_grad_add_kernel_matches_plain(cuda, shape, dtype, acc_dtype, given,
                                       route):
    """Both bf16/fp16 routes at every shape (the wgmma route where
    grad_add_route gives it, the WMMA kernel forced), fp32 on the FMA
    kernel, in place and fresh, against the plain version."""
    rows, din, dout = shape
    x, g, acc = _grad_add_inputs(cuda, rows, din, dout, dtype, acc_dtype)
    chosen = fl.grad_add_route(rows, din, dout, dtype)
    if route == "wmma" and chosen == "fma":
        with pytest.raises(ValueError, match="route"):
            fl.fused_linear_grad_add_kernel(x, g, acc, acc_dtype, route)
        return
    want = fl.fused_linear_param_grad_add_plain(
        x, g, acc.clone() if given else None, acc_dtype)
    before = fl.fused_linear_grad_add_kernel.launches
    by_route = dict(fl.fused_linear_grad_add_kernel.route_launches)
    got = fl.fused_linear_grad_add_kernel(x, g, acc if given else None,
                                          acc_dtype, route)
    torch.cuda.synchronize()
    assert fl.fused_linear_grad_add_kernel.launches == before + 1
    ran = route or chosen
    for r in fl.GRAD_ADD_ROUTES:
        assert fl.fused_linear_grad_add_kernel.route_launches[r] == \
            by_route[r] + (r == ran)
    assert got.dtype == acc_dtype and got.shape == (din, dout)
    assert (got is acc) == given
    grad_add_close(got, want, f"grad_add {ran} {shape} {dtype} -> "
                              f"{acc_dtype}")


@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (8192, 512, 512),
                                   (37, 13, 29)],
                         ids=["wgmma", "wgmma-split", "wmma"])
def test_grad_add_kernel_repeats_bitwise(cuda, shape):
    x, g, acc = _grad_add_inputs(cuda, *shape, torch.bfloat16,
                                 torch.float32)
    a = fl.fused_linear_grad_add_kernel(x, g, acc.clone(), torch.float32)
    b = fl.fused_linear_grad_add_kernel(x, g, acc.clone(), torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_grad_add_op_in_place_on_card(cuda):
    """The op updates a given fp32 accumulator in place and returns it,
    with the bias sum; a bf16 one under ``multi_precision`` is converted
    and left as it was; the CUDA path launches once per call."""
    x, g, acc = _grad_add_inputs(cuda, 3 * 70, 96, 80, torch.bfloat16,
                                 torch.float32)
    x3, g3 = x.reshape(3, 70, 96), g.reshape(3, 70, 80)
    db0 = torch.randn(80, device=cuda)
    want_w = fl.fused_linear_param_grad_add_plain(x, g, acc.clone(),
                                                  torch.float32)
    want_b = db0 + g.float().sum(0)
    before = fl.fused_linear_grad_add_kernel.launches
    dw, db = fl.fused_linear_param_grad_add(x3, g3, acc, db0)
    assert dw is acc and db is db0
    assert fl.fused_linear_grad_add_kernel.launches == before + 1
    grad_add_close(dw, want_w, "op dweight")
    torch.testing.assert_close(db, want_b, rtol=1e-5, atol=1e-4)
    low = acc.bfloat16()
    kept = low.clone()
    dw, _ = fl.fused_linear_param_grad_add(x3, g3, low, has_bias=False)
    assert dw is not low and dw.dtype == torch.float32
    assert torch.equal(low, kept)


def test_grad_add_kernel_refuses_bad_input(cuda):
    """Every refusal raises before a launch; nothing falls through to
    the plain version."""
    x = torch.randn(64, 32, device=cuda, dtype=torch.bfloat16)
    g = torch.randn(64, 48, device=cuda, dtype=torch.bfloat16)
    acc = torch.zeros(32, 48, device=cuda)
    before = fl.fused_linear_grad_add_kernel.launches
    with pytest.raises(TypeError):
        fl.fused_linear_grad_add_kernel(x.double(), g.double(), None,
                                        torch.float32)
    with pytest.raises(TypeError):
        fl.fused_linear_grad_add_kernel(x, g.float(), None, torch.float32)
    with pytest.raises(TypeError):
        fl.fused_linear_grad_add_kernel(x, g, acc.half(), torch.float16)
    with pytest.raises(ValueError, match="rows"):
        fl.fused_linear_grad_add_kernel(x, g[:10], None, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_linear_grad_add_kernel(x.t().contiguous().t(), g, None,
                                        torch.float32)
    with pytest.raises(ValueError, match="dweight"):
        fl.fused_linear_grad_add_kernel(x, g, acc[:16].contiguous(),
                                        torch.float32)
    with pytest.raises(ValueError, match="empty"):
        fl.fused_linear_grad_add_kernel(x[:, :0].contiguous(), g, None,
                                        torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fl.fused_linear_grad_add_kernel(x, g, acc.cpu(), torch.float32)
    with pytest.raises(ValueError, match="route"):
        fl.fused_linear_grad_add_kernel(x[:, :13].contiguous(), g, None,
                                        torch.float32, "wgmma")
    assert fl.fused_linear_grad_add_kernel.launches == before


def test_linear_with_main_grad_on_card_matches_cpu(cuda):
    """dx, dw, db of ``linear_with_main_grad`` on the card (dW through
    the kernel) against the CPU, fp32."""
    rng = np.random.RandomState(7)
    x, w = rng.randn(2, 33, 40), rng.randn(40, 24)
    b, cot = rng.randn(24), rng.randn(2, 33, 24)
    grads = []
    for dev in (cuda, "cpu"):
        ts = [torch.tensor(a, dtype=torch.float32, device=dev)
              .requires_grad_() for a in (x, w, b)]
        before = fl.fused_linear_grad_add_kernel.launches
        y = fl.linear_with_main_grad(*ts)
        (y * torch.tensor(cot, dtype=torch.float32, device=dev)).sum() \
            .backward()
        assert fl.fused_linear_grad_add_kernel.launches == before + (
            dev == cuda)
        grads.append([t.grad.cpu() for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_eager_llama_main_grad_on_card_matches_cpu(cuda):
    """The imperative Llama (fp32, GQA, S not a tile multiple) under
    ``GradientMergeOptimizer(MixPrecisionOptimizer(AdamW), k_steps=2)``
    for 2 updates on the card and on the CPU from the same weights:
    losses, main_grads before each update, and the weights after."""
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=1, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    ref = L.init_layers(L.LlamaForCausalLM(cfg, device="cpu"), seed=3)
    rng = np.random.RandomState(8)
    ids = rng.randint(0, cfg.vocab_size, (2, 2, 2, 70))
    labels = np.roll(ids, -1, axis=-1)
    runs = []
    for dev in (cuda, "cpu"):
        model = L.LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(ref.state_dict())
        mw = MPU.MixPrecisionLayer(model)
        opt = MO.GradientMergeOptimizer(MPU.MixPrecisionOptimizer(AdamW(
            parameters=model.parameters(), learning_rate=1e-3,
            multi_precision=True)), k_steps=2)
        losses, grads = [], []
        for s in range(2):
            for m in range(2):
                loss = mw.compute_loss(torch.from_numpy(ids[s, m]).to(dev),
                                       torch.from_numpy(labels[s, m]).to(dev))
                loss.backward()
                mw.accumulate_main_grads()
                losses.append(float(loss.detach()))
                if m == 1:
                    # a copy: the update divides main_grad by k in place
                    grads.append({n: p.main_grad.to("cpu", copy=True)
                                  for n, p in model.named_parameters()})
                opt.step()
                opt.clear_grad()
        runs.append((losses, grads, {n: p.detach().cpu()
                                     for n, p in model.named_parameters()}))
    (lc, gc, wc), (lp, gp, wp) = runs
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=1e-6)
    for step, (a, b) in enumerate(zip(gc, gp)):
        for n in b:
            l2_close(a[n], b[n], MAIN_GRAD_PARITY_TOL,
                     f"step {step} main_grad {n}")
    trained_weights_close(wc, wp, lr=1e-3, steps=2)
