"""Card-only tests of the PyTorch/CUDA port: each kernel against its
plain PyTorch version at Llama-2-7B and BERT-large widths, the wrappers'
argument checks, the serving engine (greedy, sampled, constrained and
speculative; bf16 speculative streams equal to the plain ones), the
generate engines, the Llama and ERNIE training steps
and main-grad training of the imperative Llama on the card against the
same on the CPU, and the training steps' launch counts. Marked ``gpu``; they skip where no CUDA device is
present. Run on the card (the machine there has no JAX, so skip the
conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Whether a card exists is decided inside the fixture, never at import.
"""

import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.fleet import meta_optimizers as MO
from paddle_tpu_torch.distributed.fleet.utils import (
    mix_precision_utils as MPU)
from paddle_tpu_torch.inference import constrain as C
from paddle_tpu_torch.inference import decoding as D
from paddle_tpu_torch.inference.sampling import SamplerConfig
from paddle_tpu_torch.inference.speculative import Drafter
from paddle_tpu_torch.models import ernie as E
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops import _common
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


def _unified_flags(args):
    """The ``decoding`` flags the unified step passes with a batch of
    :func:`_mixed_batch`: a row's lone token is its decode carry; a
    prompt chunk's tokens do not decode."""
    tr, n_rows = args[4], args[3].shape[0]
    counts = torch.bincount(tr[tr >= 0].long(), minlength=n_rows)
    return (tr >= 0) & (counts[tr.long().clamp(min=0)] == 1)


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
@pytest.mark.parametrize("flags", ["unified", "unflagged"])
def test_ragged_attention_kernel_matches_plain(cuda, dtype, nh, nkv, d,
                                               page, width, rows, scatter,
                                               flags):
    """Every route against the plain version: the call's own routes
    (wgmma tiles and the key split where ragged_route says so; page 12
    and fp32 take the key split alone) and the key split forced for
    every token; the kernels' tile map equals ``ragged_tiles``. The
    ``decoding`` flags are the unified step's (the decode rows' lone
    tokens on the key split), or none (every lone token, a decode row's
    too, a one-token wgmma tile, as a lone prompt token is)."""
    kw = {} if rows is None else dict(rows=rows)
    args = _mixed_batch(cuda, dtype, nh, nkv, d, page=page, width=width,
                        scatter=scatter, **kw)
    dec = (_unified_flags(args) if flags == "unified"
           else torch.zeros_like(args[4], dtype=torch.bool))
    routes = pa.ragged_route(dtype, page, nh, nkv)
    before = dict(pa.ragged_paged_attention.route_launches)
    calls = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(*args, decoding=dec)
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
    pa.ragged_paged_attention_kernel(*args, dec, tile_map=tile_map)
    n_rows = args[3].shape[0]
    torch.testing.assert_close(tile_map, pa.ragged_tiles(args[4], n_rows,
                                                         ts, dec))
    split = pa.ragged_paged_attention_kernel(*args, dec, route="key_split")
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
    dec = _unified_flags(args)
    page, nh, nkv = 16, 32, 8
    before = pa.ragged_paged_attention.route_launches["merge"]
    tile_map = torch.full((args[0].shape[0],), -7, dtype=torch.int32,
                          device=cuda)
    for route in (None, "key_split"):
        got = pa.ragged_paged_attention_kernel(*args, dec, route=route,
                                               tile_map=tile_map,
                                               chunk=chunk)
        torch.cuda.synchronize()
        _check_ragged(args, got, f"{route} chunk {chunk}")
        ts = (pa.ragged_tile_size(dtype, page, nh, nkv) if route is None
              else 1)
        torch.testing.assert_close(
            tile_map, pa.ragged_tiles(args[4], args[3].shape[0], ts, dec))
    merges = pa.ragged_paged_attention.route_launches["merge"] - before
    assert merges == (2 if chunk < 24 * page else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_attention_kernels_repeat_bitwise(cuda, dtype):
    args = _mixed_batch(cuda, dtype, 32, 8, 128, width=24, rows=_LONG_ROWS)
    dec = _unified_flags(args)
    for route in (None, "key_split"):
        a = pa.ragged_paged_attention_kernel(*args, dec, route=route)
        b = pa.ragged_paged_attention_kernel(*args, dec, route=route)
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
    dec = _unified_flags((q, k, v, bt, tr, pos, kvl))
    want = pa.ragged_paged_attention_plain(q, k, v, bt, tr, pos, kvl)
    for route in (None, "key_split"):
        got = pa.ragged_paged_attention_kernel(q, k, v, bt, tr, pos, kvl,
                                               dec, route=route)
        torch.cuda.synchronize()
        assert bool((got[tr == 2] == 0).all()), route
        torch.testing.assert_close(got[tr != 2].float(),
                                   want[tr != 2].float(), rtol=2e-2,
                                   atol=2e-2)


def test_ragged_attention_kernel_rejects_bad_input(cuda):
    q, k, v, bt, tr, pos, kvl = _mixed_batch(cuda, torch.float32, 4, 4,
                                             d=128)
    dec = _unified_flags((q, k, v, bt, tr, pos, kvl))
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q.half(), k, v, bt, tr, pos, kvl,
                                  decoding=dec)
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q, k, v, bt, tr, pos.long(), kvl,
                                  decoding=dec)
    with pytest.raises(ValueError, match="head_dim"):
        pa.ragged_paged_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  v[..., :96].contiguous(), bt, tr, pos, kvl,
                                  decoding=dec)
    with pytest.raises(ValueError, match="route"):
        pa.ragged_paged_attention_kernel(q, k, v, bt, tr, pos, kvl, dec,
                                         route="wgmma")   # fp32 pools
    with pytest.raises(ValueError, match="decoding"):
        pa.ragged_paged_attention(q, k, v, bt, tr, pos, kvl)
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(q, k, v, bt, tr, pos, kvl,
                                  decoding=dec.int())


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


def _card_serve(cuda, cfg, params, prompts, graphs, **geo):
    """A fresh card engine (CUDA graphs on, or the eager card run) serves
    ``prompts``. Returns the engine, the card's params, its tokens and the
    advance of every registered launch counter."""
    eng = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=6), device=cuda, **geo)
    eng._graphs = graphs
    gpu = {k: t.to(cuda) for k, t in params.items()}
    before = _common.launch_counts()
    out = eng.serve(gpu, prompts)
    torch.cuda.synchronize()
    after = _common.launch_counts()
    return eng, gpu, out, {k: n - before[k] for k, n in after.items()}


def _check_programs_on_card(cuda, cfg, prompts, **geo):
    """fp32 greedy tokens through the CUDA graphs == the eager card run's
    == the CPU's (plain versions); every launch counter advances as in
    the eager run (replays counted); a repeat serve replays without a
    new miss (with the prefix cache: the second repeat, whose waves are
    warm like the first's); and new weights on the same engine give the
    CPU's tokens for them."""
    cache = geo.get("prefix_cache", False)
    params = L.init_params(cfg, seed=1, device="cpu")
    want = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=6), device="cpu",
        **geo).serve(params, prompts)
    eng, gpu, got, counts = _card_serve(cuda, cfg, params, prompts, True,
                                        **geo)
    _, _, eager, eager_counts = _card_serve(cuda, cfg, params, prompts,
                                            False, **geo)
    assert got == eager == want
    assert counts == eager_counts and any(counts.values())
    if cache:
        assert eng.cache.snapshot()["cow_copies"] >= 1
    names = {n for n, _ in eng.compile_misses}
    assert set(eng.capture_seconds) == names
    assert all(sec > 0 for sec in eng.capture_seconds.values())
    for _ in range(1 + cache):
        n0 = len(eng.compile_misses)
        again = eng.serve(gpu, prompts)
    assert len(eng.compile_misses) == n0
    if not cache:
        assert again == got
    other = L.init_params(cfg, seed=2, device="cpu")
    if cache:
        eng.cache.evict(eng.mgr.num_pages)      # no KV of the old weights
    swapped = eng.serve({k: t.to(cuda) for k, t in other.items()}, prompts)
    assert len(eng.compile_misses) > n0
    assert swapped == D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=6), device="cpu",
        **geo).serve(other, prompts)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_on_card_matches_cpu(cuda, prefix_cache):
    """The unified pipeline (and, with the cache, a shared-prefix request
    and an exact repeat for COW), MHA and GQA at head_dim 128:
    :func:`_check_programs_on_card`."""
    for nkv in (4, 2):
        cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=nkv, intermediate_size=512,
                           num_hidden_layers=2)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (4, 33, 18, 2, 32)]
        if prefix_cache:
            prompts += [np.concatenate([prompts[1][:20], prompts[0]]),
                        prompts[4].copy()]
        _check_programs_on_card(cuda, cfg, prompts, num_slots=2,
                                page_size=16, max_seq_len=96, chunk=3,
                                prefix_cache=prefix_cache)


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
    """The legacy pipeline (prefill programs per key, the decode chunk;
    with the cache, a shared-prefix wave and an exact repeat for COW),
    MHA and GQA at head_dim 128: :func:`_check_programs_on_card`."""
    for nkv in (4, 2):
        cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=nkv, intermediate_size=512,
                           num_hidden_layers=2)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (4, 33, 18, 2, 32)]
        prompts += [np.concatenate([prompts[1][:20], prompts[0]]),
                    prompts[4].copy()]
        _check_programs_on_card(cuda, cfg, prompts, num_slots=2,
                                page_size=16, max_seq_len=96, chunk=4,
                                unified=False, prefix_cache=prefix_cache)


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
# the generate engines: GenerationEngine (contiguous cache) and
# PagedGenerationEngine, each one CUDA graph a key
# ---------------------------------------------------------------------------

_GEN_CFG = dict(hidden_size=256, num_attention_heads=2, intermediate_size=512,
                num_hidden_layers=2)


@pytest.mark.parametrize("gen", [dict(), dict(do_sample=True,
                                              temperature=0.8, top_k=30,
                                              top_p=0.9, seed=6)],
                         ids=["greedy", "sampled"])
def test_generation_engine_on_card_matches_cpu(cuda, gen):
    """``llama_engine`` (fp32, GQA, d 128): two prompt lengths of one
    bucket (5 and 9 of 16) replay ONE CUDA graph, each with its own
    tokens, equal to the eager card run's and the CPU's; greedy and
    sampled."""
    cfg = L.llama_tiny(num_key_value_heads=1, **_GEN_CFG)
    params = L.init_params(cfg, seed=2, device="cpu")
    rng = np.random.RandomState(5)
    calls = [rng.randint(1, cfg.vocab_size, (3, n)).astype(np.int32)
             for n in (5, 9, 5)]
    conf = D.GenerationConfig(max_new_tokens=7, **gen)
    outs = []
    for dev, graphs in (("cpu", False), (cuda, True), (cuda, False)):
        eng = D.llama_engine(cfg, conf, device=dev)
        eng._graphs = graphs
        p = {k: t.to(dev) for k, t in params.items()}
        outs.append([eng.generate(p, ids) for ids in calls])
        assert eng.compile_misses == [("generation_engine.run", (16, 7, 3))]
    for card in outs[1:]:
        for a, b in zip(card, outs[0]):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs[0][0], outs[0][1])


def test_generation_engine_bf16_graph_equals_eager(cuda):
    """bf16 ``llama_engine``: the graph's tokens equal the eager card
    run's; a generate launches RMSNorm 2L+1 times a step (the prefill and
    max_new - 1 decode steps), graph replays counted; the capture's
    seconds and pool bytes are booked; a new key drops the last key's
    graph and cache."""
    cfg = L.llama_tiny(num_key_value_heads=2, dtype=torch.bfloat16,
                       **_GEN_CFG)
    params = L.init_params(cfg, seed=4, device=cuda)
    ids = np.random.RandomState(6).randint(
        1, cfg.vocab_size, (4, 20)).astype(np.int32)
    outs = []
    for graphs in (True, False):
        eng = D.llama_engine(cfg, D.GenerationConfig(max_new_tokens=9),
                             device=cuda)
        eng._graphs = graphs
        eng.generate(params, ids)
        rn.rms_norm.launches = 0
        outs.append(eng.generate(params, ids))
        torch.cuda.synchronize()
        assert rn.rms_norm.launches == (2 * 2 + 1) * 9
        assert len(eng.compile_misses) == 1
    np.testing.assert_array_equal(outs[0], outs[1])
    eng = D.llama_engine(cfg, D.GenerationConfig(max_new_tokens=9),
                         device=cuda)
    eng.generate(params, ids)
    assert eng.capture_seconds["generation_engine.run"] > 0
    assert eng.graph_pool_bytes["generation_engine.run"] > 0
    eng.generate(params, ids[:2])      # another key: the last one dropped
    assert len(eng._compiled) == 1 and len(eng.compile_misses) == 2


def test_paged_generation_engine_graph_one_build(cuda):
    """bf16 ``PagedGenerationEngine``: two calls of one key (other
    prompts, same bucket and widest table) replay one CUDA graph over the
    key's kept pool; a call of another key drops that graph and pool (one
    key held at a time), and the first key again is a new build; tokens
    equal the eager card run's."""
    cfg = L.llama_tiny(num_key_value_heads=1, dtype=torch.bfloat16,
                       **_GEN_CFG)
    params = L.init_params(cfg, seed=2, device=cuda)
    rng = np.random.RandomState(8)
    batches = [[rng.randint(1, cfg.vocab_size, n).astype(np.int32)
                for n in lens]
               for lens in ((3, 17, 40), (33, 40, 9), (5, 6), (3, 17, 40))]
    outs = []
    for graphs in (True, False):
        eng = D.PagedGenerationEngine(cfg, D.GenerationConfig(
            max_new_tokens=7), page_size=16, device=cuda)
        eng._graphs = graphs
        out, pools = [], []
        for p in batches:
            out.append(eng.generate(params, p))
            pools.append(eng._mgr)
            assert len(eng._compiled) == 1
        outs.append(out)
        assert pools[0] is pools[1] and pools[2] is not pools[1]
        assert eng.compile_misses == [("paged_engine.run", (64, 7, 3, 3)),
                                      ("paged_engine.run", (16, 7, 2, 1)),
                                      ("paged_engine.run", (64, 7, 3, 3))]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sampling slice: sampled, constrained and speculative serves
# ---------------------------------------------------------------------------

def _sampling_kinds(vocab_size):
    """Greedy, sampled (temperature / top-k / top-p), constrained
    (sampled under ``(ab|cd)*e``) and near-greedy sampled requests."""
    vocab = (["<eos>"] + list("abcde")
             + [f"tok{i}" for i in range(6, vocab_size)])
    gram = C.compile_regex("(ab|cd)*e", vocab, eos_token_id=0)
    kinds = [dict(),
             dict(sampler=SamplerConfig(temperature=0.9, top_k=20,
                                        top_p=0.9, seed=3)),
             dict(grammar=gram,
                  sampler=SamplerConfig(temperature=1.0, seed=4)),
             dict(sampler=SamplerConfig(temperature=0.05, seed=5))]
    return gram, kinds


def _serve_kinds(eng, params, prompts, subs):
    rids = [eng.submit(p, **s) for p, s in zip(prompts, subs)]
    out, steps = {}, 0
    while len(out) < len(rids):
        eng.step(params)
        eng.mgr.check_conservation()
        out.update(eng.collect())
        steps += 1
        assert steps < 500
    return [out[r] for r in rids]


@pytest.mark.parametrize("speculative", [False, True])
def test_sampled_constrained_serve_on_card_matches_cpu(cuda, speculative):
    """A mixed greedy / sampled / constrained serve (speculative or not,
    fp32, GQA): tokens through the CUDA graphs == the eager card run's ==
    the CPU's; constrained streams legal; the programs built once, with
    the sampling epilogue on from the first submit."""
    cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2)
    params = L.init_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (4, 33, 18, 2, 32, 9, 21)]
    gram, kinds = _sampling_kinds(cfg.vocab_size)
    subs = [kinds[i % len(kinds)] for i in range(len(prompts))]
    geo = dict(num_slots=3, page_size=16, max_seq_len=96, chunk=3,
               grammar_states=gram.n_states, speculative=speculative,
               spec_k=3)
    outs = []
    for dev, graphs in (("cpu", False), (cuda, True), (cuda, False)):
        eng = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=8), device=dev, **geo)
        eng._graphs = graphs
        outs.append(_serve_kinds(eng, {k: t.to(dev) for k, t in
                                       params.items()}, prompts, subs))
        name = "cbe.spec_step" if speculative else "cbe.unified_step"
        assert [(n, k[-1]) for n, k in eng.compile_misses] == [(name, True)]
        assert eng.sampling_counts["paddle_sampling_violations_total"] == 0
    assert outs[1] == outs[2] == outs[0]
    for i, toks in enumerate(outs[0]):
        if "grammar" in subs[i]:
            st = gram.start
            for t in toks:
                assert gram.legal(st, t)
                st = gram.advance(st, t)


@pytest.mark.parametrize("unified", [True, False])
def test_do_sample_on_card_matches_cpu(cuda, unified):
    """``GenerationConfig(do_sample=True)`` on the unified step (per-
    request samplers), the legacy programs (the key chain split per
    wave, chunk and step, on the card inside the graphs) and
    ``PagedGenerationEngine``: card tokens == the CPU's."""
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=1, intermediate_size=512,
                       num_hidden_layers=2)
    params = L.init_params(cfg, seed=2, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 17, 40, 8)]
    gen = D.GenerationConfig(max_new_tokens=7, do_sample=True,
                             temperature=0.8, top_k=30, top_p=0.9, seed=6)
    outs = []
    for dev, graphs in (("cpu", False), (cuda, True), (cuda, False)):
        eng = D.ContinuousBatchingEngine(cfg, gen, num_slots=2,
                                         page_size=16, max_seq_len=64,
                                         chunk=3, device=dev,
                                         unified=unified)
        eng._graphs = graphs
        outs.append(eng.serve({k: t.to(dev) for k, t in params.items()},
                              prompts))
    assert outs[1] == outs[2] == outs[0]
    gen_out = [D.PagedGenerationEngine(cfg, gen, page_size=16,
                                       device=dev).generate(
        {k: t.to(dev) for k, t in params.items()}, prompts)
        for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(gen_out[0], gen_out[1])


class _AlwaysDraft(Drafter):
    """Drafts k tokens every round (the row's last token repeated)."""

    def draft(self, history, k):
        return [int(history[-1])] * k


def test_spec_step_spans_take_the_key_split(cuda):
    """bf16 pools at page 16: a speculative round's ``[carry, d1..dk]``
    spans are flagged ``decoding``, so every span token is a tile of its
    own on the key split (``ragged_tiles`` over the round's plan with its
    flags: 15 one-token tiles; ``route_launches["key_split"]`` once per
    layer and round), as the unified step decodes a token; the greedy
    tokens through the graphs equal the eager card run's."""
    cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                       num_key_value_heads=4, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=3, device=cuda)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (12, 30, 7)]
    outs = []
    for graphs in (True, False):
        eng = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=40), num_slots=3,
            page_size=16, max_seq_len=96, chunk=2, device=cuda,
            speculative=True, spec_k=4, drafter=_AlwaysDraft())
        eng._graphs = graphs
        rids = [eng.submit(p) for p in prompts]
        for _ in range(10):               # until every row decodes
            if all(eng._pend[s] is None and eng._slot_rid[s] is not None
                   for s in range(3)):
                break
            eng.step(params)
        _common.add_launch_counts({k: -n for k, n in
                                   _common.launch_counts().items()})
        eng.step(params)                   # a decode round: 3 spans of 5
        torch.cuda.synchronize()
        op = pa.ragged_paged_attention
        assert op.launches == 2 and op.route_launches["key_split"] == 2
        static = eng._spec_step.static
        ts = pa.ragged_tile_size(torch.bfloat16, 16, 4, 4)
        tiles = pa.ragged_tiles(static["token_row"], 3, ts,
                                static["decoding"]).cpu().numpy()
        starts, sizes = np.unique(tiles[tiles >= 0], return_counts=True)
        assert len(starts) == 15 and (sizes == 1).all()
        assert bool(static["decoding"][static["token_row"] >= 0].all())
        out = {}
        while len(out) < len(rids):
            eng.step(params)
            out.update(eng.collect())
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# a token's bits do not depend on its packing: speculative greedy streams
# equal the plain greedy streams at bf16
# ---------------------------------------------------------------------------

def _packed_call(cuda, pool, entries, n_tokens):
    """One ragged call over ``pool`` (bf16 K/V, tables, per-(row,
    position) queries, each row's length) with the tokens ``entries``
    ((row, position, decoding) each) packed from slot 0 and pads after.
    A row's kv_len is its last entry's position + 1 (a row without
    entries keeps its length). Returns the (T, nh, d) output."""
    k, v, bt, qtab, lens = pool
    tr = np.full(n_tokens, -1, np.int32)
    pos = np.zeros(n_tokens, np.int32)
    dec = np.zeros(n_tokens, bool)
    kv_lens = np.asarray(lens, np.int32)
    for i, (r, p, d) in enumerate(entries):
        tr[i], pos[i], dec[i] = r, p, d
        kv_lens[r] = p + 1
    rows = torch.as_tensor(np.maximum(tr, 0), device=cuda).long()
    q = qtab[rows, torch.as_tensor(pos, device=cuda).long()].contiguous()
    meta = [torch.as_tensor(a, device=cuda) for a in (bt, tr, pos, kv_lens)]
    out = pa.ragged_paged_attention(
        q, k, v, *meta, decoding=torch.as_tensor(dec, device=cuda))
    torch.cuda.synchronize()
    return out


def _span_pool(cuda, nh, nkv, d=128, page=16, width=32):
    rng = np.random.RandomState(7)
    lens = [240, 200, 77, 301]          # row 0 is the row under test
    n_pages = len(lens) * width + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(lens), width), np.int32)
    for r in range(len(lens)):
        bt[r] = perm[r * width:(r + 1) * width]
    gen = torch.Generator(device=cuda).manual_seed(8)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(pool, generator=gen, device=cuda).to(torch.bfloat16)
    qtab = torch.randn((len(lens), width * page, nh, d), generator=gen,
                       device=cuda).to(torch.bfloat16)
    return k, v, bt, qtab, lens


@pytest.mark.parametrize("nkv", [32, 8], ids=["mha", "gqa4"])
@pytest.mark.parametrize("kind,n", [("decode", 5), ("prompt", 70)])
def test_ragged_token_bits_do_not_depend_on_its_packing(cuda, nkv, kind, n):
    """bf16, page 16, nh 32: a row's ``n`` tokens at positions
    150-n+1..150, packed as one span of the row (beside other rows'
    decode tokens), against each token packed alone at its position
    (same pool, same T, same rows): bitwise equal. ``decode``: a
    speculative span ``[carry, d1..d4]``, flagged ``decoding`` as the
    spec step flags it, against the unified step's lone decode token (the
    key split either way). ``prompt``: a prefill run of 70 tokens (two
    tiles at nkv 32, five at nkv 8) against each token alone, unflagged
    (the wgmma tiles either way, a lone token a tile of one)."""
    pool = _span_pool(cuda, 32, nkv)
    flag = kind == "decode"
    others = [(1, 199, True), (2, 76, True), (3, 300, True)]
    first = 150 - n + 1
    span = [(0, first + j, flag) for j in range(n)]
    n_tokens = 96
    got = _packed_call(cuda, pool, others[:1] + span + others[1:],
                       n_tokens)
    for j in range(n):
        alone = _packed_call(cuda, pool, others[:1] + [span[j]]
                             + others[1:], n_tokens)
        a, b = alone[1], got[1 + j]
        assert torch.equal(a, b), (
            f"token {j} of the span (position {first + j}): "
            f"{int((a != b).sum())} of {a.numel()} elements differ, "
            f"max {float((a.float() - b.float()).abs().max())}")


def test_lm_head_rows_do_not_depend_on_row_count(cuda):
    """The logits of a hidden row taken among 8 gathered rows (the
    unified step's one a slot) and among 40 (the spec step's k+1 a slot)
    at Llama-2-7B's (h 4096, V 32000) in bf16, as ``ragged_step`` takes
    them (``x[last_idx] @ lm_head``): bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((256, 4096), generator=gen, device=cuda).to(
        torch.bfloat16)
    w = (0.02 * torch.randn((4096, 32000), generator=gen, device=cuda)).to(
        torch.bfloat16)
    idx40 = torch.arange(40, device=cuda) * 6
    idx8 = idx40[::5]
    a = x[idx8] @ w
    b = (x[idx40] @ w)[::5]
    torch.cuda.synchronize()
    assert torch.equal(a, b), (f"{int((a != b).sum())} of {a.numel()} "
                               "logits differ")


@pytest.mark.parametrize("drafter", ["always", "ngram", "plain_stream"])
def test_bf16_spec_greedy_streams_equal_plain_streams(cuda, drafter):
    """The reference's promise: speculative greedy output equals the
    non-speculative greedy output. A tiny bf16 engine (3 slots, page 16,
    max_seq_len 96, chunk 2, both programs on a 16-token axis), five
    prompts through the three slots, 40 new tokens, through the CUDA
    graphs: ``speculative=True, spec_k=4`` with drafts of k copies of
    the last token, the n-gram drafter, or the plain engine's own
    streams (all accepted) gives the plain engine's tokens."""
    cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                       num_key_value_heads=4, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=3, device=cuda)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (12, 30, 7, 17, 1)]
    geo = dict(num_slots=3, page_size=16, max_seq_len=96, chunk=2,
               device=cuda)
    gen = D.GenerationConfig(max_new_tokens=40)
    plain = D.ContinuousBatchingEngine(cfg, gen, **geo).serve(params,
                                                              prompts)
    make = {"always": _AlwaysDraft, "ngram": lambda: None,
            "plain_stream": lambda: _StreamDrafter(prompts, plain)}
    eng = D.ContinuousBatchingEngine(cfg, gen, speculative=True, spec_k=4,
                                     drafter=make[drafter](), **geo)
    assert eng._spec_tokens == 16
    spec = eng.serve(params, prompts)
    assert eng.spec.stats["drafted"] > 0 or drafter == "ngram"
    if drafter == "plain_stream":
        assert eng.spec.stats["accepted"] == eng.spec.stats["drafted"]
    same = [a == b for x, y in zip(spec, plain) for a, b in zip(x, y)]
    assert spec == plain, f"{sum(same)} of {len(same)} tokens equal"


@pytest.mark.parametrize("k_dim,n_dim", [(4096, 4096), (4096, 11008),
                                         (11008, 4096), (4096, 32000),
                                         (512, 512)])
@pytest.mark.parametrize("m_dim", [16, 40, 256])
def test_projection_rows_do_not_depend_on_their_neighbours(cuda, k_dim,
                                                           n_dim, m_dim):
    """bf16 ``(1, M, K) @ (K, N)`` as ``ragged_step`` runs its q/k/v/o,
    MLP and lm_head projections (Llama-2-7B's and the tiny tests' widths):
    at one row count M, a hidden row's product is bitwise the same at any
    index among any other rows, as a token packed at another slot of the
    same token axis. (At another M it need not be: cuBLAS picks its
    kernel by shape, and at (4096, 4096) a row among 16 and among 40
    differ; so the speculative and plain steps agree only on one axis.)"""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((2 * m_dim, k_dim), generator=gen, device=cuda).to(
        torch.bfloat16)
    w = (0.02 * torch.randn((k_dim, n_dim), generator=gen,
                            device=cuda)).to(torch.bfloat16)
    base = (x[None, :m_dim] @ w)[0]
    perm = torch.randperm(m_dim, device=cuda)
    others = torch.arange(m_dim, 2 * m_dim, device=cuda)
    idx = torch.where(torch.arange(m_dim, device=cuda) % 2 == 0, perm,
                      others)             # half the rows, moved
    got = (x[idx][None] @ w)[0]
    kept = idx < m_dim
    want = base[idx[kept]]
    torch.cuda.synchronize()
    assert torch.equal(got[kept], want), (
        f"{int((got[kept] != want).sum())} of {want.numel()} products "
        "differ")


@pytest.mark.parametrize("widths", ["tiny", "tiny-gqa", "7b"])
@pytest.mark.parametrize("drafter", ["ngram", "plain_stream"])
def test_bf16_spec_streams_equal_plain_streams_on_one_token_axis(
        cuda, widths, drafter):
    """The reference's promise at 8 slots, page 16, the default chunk,
    bf16, through the CUDA graphs, with both engines on one packed axis
    (``step_tokens`` 40 = slots·(k+1), as the speculative step needs):
    12 prompts through the slots, 24 new tokens each; the speculative
    greedy streams (n-gram drafts, or the plain streams themselves, all
    accepted) equal the plain greedy streams, also at Llama-2-7B's
    widths (2 layers)."""
    cfg = (L.llama2_7b(num_hidden_layers=2, dtype=torch.bfloat16)
           if widths == "7b" else
           L.llama_tiny(hidden_size=512, num_attention_heads=8,
                        num_key_value_heads=2 if widths == "tiny-gqa"
                        else 8, intermediate_size=512,
                        num_hidden_layers=2, dtype=torch.bfloat16))
    params = L.init_params(cfg, seed=4, device=cuda)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(1, 60, size=12)]
    geo = dict(num_slots=8, page_size=16, max_seq_len=128, step_tokens=40,
               device=cuda)
    gen = D.GenerationConfig(max_new_tokens=24)
    plain = D.ContinuousBatchingEngine(cfg, gen, **geo).serve(params,
                                                              prompts)
    eng = D.ContinuousBatchingEngine(
        cfg, gen, speculative=True, spec_k=4,
        drafter=(_StreamDrafter(prompts, plain) if drafter == "plain_stream"
                 else None), **geo)
    assert eng._spec_tokens == 40
    spec = eng.serve(params, prompts)
    if drafter == "plain_stream":
        assert eng.spec.stats["accepted"] == eng.spec.stats["drafted"] > 0
    same = [a == b for x, y in zip(spec, plain) for a, b in zip(x, y)]
    assert spec == plain, f"{sum(same)} of {len(same)} tokens equal"


class _StreamDrafter(Drafter):
    """Drafts the next tokens of known streams, found by the prompt the
    history starts with."""

    def __init__(self, prompts, streams):
        self.refs = [([int(t) for t in p], list(map(int, o)))
                     for p, o in zip(prompts, streams)]

    def draft(self, history, k):
        for prompt, out in self.refs:
            if list(history[:len(prompt)]) == prompt:
                done = len(history) - len(prompt)
                return out[done:done + k]
        return []


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
        opt = E.AdamW(learning_rate=1e-3, parameters=model.named_parameters())
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


# ---------------------------------------------------------------------------
# the serving scheduler over the card's engine
# ---------------------------------------------------------------------------

def _sched_cfg():
    return L.llama_tiny(hidden_size=512, num_attention_heads=4,
                        num_key_value_heads=4, intermediate_size=512,
                        num_hidden_layers=2)


def _sched_engine(cfg, device, **kw):
    return D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=6), num_slots=2,
        page_size=16, max_seq_len=96, chunk=3, device=device, **kw)


def _sched_prompts(cfg, n=7):
    rng = np.random.RandomState(5)
    return [rng.randint(1, cfg.vocab_size, (int(m),)).astype(np.int32)
            for m in rng.randint(2, 40, size=n)]


def _scheduled(eng, params, prompts, sleep=time.sleep, **cfg_kw):
    """Serve through ``ServingScheduler``: priority i % 3, queue cap 5
    (two shed at submit), request 1 cancelled by its own on_token after
    its 2nd token. Returns the scheduler, the handles and the admitted
    handles in admission order."""
    from paddle_tpu_torch.serving import SchedulerConfig, ServingScheduler
    sched = ServingScheduler(eng, SchedulerConfig(max_queue_depth=5,
                                                  **cfg_kw), sleep=sleep)
    box = {}

    def stop(tok):
        if len(box["h"].stream.tokens) == 2:
            sched.cancel(box["h"].rid)

    hs = [sched.submit(p, priority=i % 3, on_token=stop if i == 1 else None)
          for i, p in enumerate(prompts)]
    box["h"] = hs[1]
    while sched.pending:
        sched.step(params)
    order = sorted((h for h in hs if h.engine_rid is not None),
                   key=lambda h: h.engine_rid)
    return sched, hs, order


def test_scheduled_serve_on_card_equals_engine_oracle_and_cpu(cuda):
    """The scheduler over the card's engine (CUDA graphs): every finished
    stream equals the same engine's plain serve of the admitted prompts in
    admission order, and equals the CPU port's scheduled serve; the shed
    and cancelled requests are the reference policy's."""
    cfg = _sched_cfg()
    params = L.init_params(cfg, seed=1, device="cpu")
    gpu = {k: t.to(cuda) for k, t in params.items()}
    prompts = _sched_prompts(cfg)
    eng = _sched_engine(cfg, cuda)
    sched, hs, order = _scheduled(eng, gpu, prompts)
    # priorities 0 1 2 0 1 2 0 under a cap of 5: the 6th submit sheds
    # the latest priority-2 arrival (5), the 7th the other one (2)
    assert [h.rid for h in hs if h.state == "shed"] == [2, 5]
    assert hs[1].state == "cancelled" and len(hs[1].stream.tokens) == 2
    n0 = len(eng.compile_misses)
    oracle = eng.serve(gpu, [h.prompt for h in order])
    assert len(eng.compile_misses) == n0            # the oracle replays
    for h, want in zip(order, oracle):
        if h.state == "done":
            assert h.stream.result() == want
        else:
            assert h.stream.tokens == want[:len(h.stream.tokens)]
    _, cpu_hs, _ = _scheduled(_sched_engine(cfg, "cpu"), params, prompts)
    assert [h.stream.tokens for h in hs] == [h.stream.tokens
                                             for h in cpu_hs]
    assert eng.mgr.num_free_pages == eng.mgr.usable_pages
    text = sched.metrics.to_prometheus_text()
    assert 'paddle_serving_requests_shed_total{reason="queue_full"} 2' in text


@pytest.mark.parametrize("when", ["build", "build_tight", "replay"])
def test_watchdog_scheduler_on_card_builds_and_replays(cuda, when):
    """``step_timeout_s`` runs each engine step on the watchdog thread:
    a first step that captures the program there (with a generous
    timeout; with a timeout shorter than the capture, so the retries wait
    on the straggler while the calling thread runs CUDA work of its own
    during the capture), and steps that replay there, give the tokens of
    the plain scheduled serve."""
    cfg = _sched_cfg()
    params = L.init_params(cfg, seed=1, device="cpu")
    gpu = {k: t.to(cuda) for k, t in params.items()}
    prompts = _sched_prompts(cfg)
    _, want, _ = _scheduled(_sched_engine(cfg, cuda), gpu, prompts)
    eng = _sched_engine(cfg, cuda)
    if when == "replay":
        eng.serve(gpu, prompts[:2])
    n0 = len(eng.compile_misses)
    kw, sleep = dict(step_timeout_s=30.0), time.sleep
    if when == "build_tight":
        def sleep(dt):
            # CUDA work (an allocation and a sync) on this thread while
            # the watchdog thread may be capturing
            assert torch.ones(1024, device=cuda).sum().item() == 1024
            time.sleep(dt)
        kw = dict(step_timeout_s=1e-3, max_step_retries=100_000,
                  retry_backoff_s=1e-3, retry_backoff_multiplier=1.0)
    sched, hs, _ = _scheduled(eng, gpu, prompts, sleep=sleep, **kw)
    if when == "build_tight":
        assert sched.metrics.counters["step_failures_total"] >= 1
    assert not sched.degraded
    assert [h.stream.tokens for h in hs] == [h.stream.tokens for h in want]
    assert [h.state for h in hs] == [h.state for h in want]
    assert len(eng.compile_misses) == n0 + (when != "replay")
    eng.mgr.check_conservation()


def test_memory_ledger_bytes_equal_tensor_nbytes_on_card(cuda):
    """An armed memory ledger over a bf16 serve on the card counts the
    weights and the pool exactly as the tensors' ``nbytes``, and its
    planner verdict predicts the pool's pages; the capacity plan for the
    card's own memory is a real one."""
    from paddle_tpu_torch.observability import memory as M
    cfg = L.llama_tiny(hidden_size=512, num_attention_heads=4,
                       num_key_value_heads=4, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=1, device=cuda)
    M.memory_ledger.reset()
    M.memory_ledger.arm()
    try:
        eng = _sched_engine(cfg, cuda, prefix_cache=True)
        eng.serve(params, _sched_prompts(cfg, 4))
        snap = M.memory_ledger.snapshot()
    finally:
        M.memory_ledger.disarm()
        M.memory_ledger.reset()
    assert snap["classes"]["weights"] == sum(t.nbytes
                                             for t in params.values())
    pool = snap["pools"][0]
    assert pool["pool_bytes"] == eng.mgr.k_pages.nbytes \
        + eng.mgr.v_pages.nbytes
    assert pool["page_bytes"] == eng.mgr.page_nbytes
    assert pool["planner"]["exact"]
    total = torch.cuda.get_device_properties(cuda).total_memory
    plan = M.plan_capacity(num_layers=2, num_kv_heads=4, head_dim=128,
                           page_size=16, dtype_bytes=2, hbm_bytes=total,
                           weight_bytes=snap["classes"]["weights"],
                           max_seq_len=96)
    assert plan.max_pages * eng.mgr.page_nbytes <= total
    assert plan.max_slots >= 1


# ---------------------------------------------------------------------------
# the serving fleet: page migration and failover on the card
# ---------------------------------------------------------------------------

def _card_pool(cuda, dtype, num_pages=12):
    from paddle_tpu_torch.kvcache.pool import RefcountedKVCacheManager
    return RefcountedKVCacheManager(4, num_pages, 16, 8, 128, dtype=dtype,
                                    device=cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_export_write_page_round_trip_bitwise_on_card(cuda, dtype):
    """A page's K and V slabs leave the card (``export_page``), cross the
    wire frame and land in another page and another pool
    (``write_page``, in place) bit for bit; the other pages and the
    pool's addresses do not move."""
    from paddle_tpu_torch.serving import wire
    src, dst = _card_pool(cuda, dtype), _card_pool(cuda, dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for pool in (src.k_pages, src.v_pages, dst.k_pages, dst.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=gen,
                               device=cuda).to(dtype))
    ptrs = (dst.k_pages.data_ptr(), dst.v_pages.data_ptr())
    keep = dst.k_pages.clone(), dst.v_pages.clone()
    pages = [3, 7]
    ks, vs = zip(*(src.export_page(p) for p in pages))
    _, meta, arrays = wire.decode_message(
        wire.encode_pages("kv", {}, list(ks), list(vs)))
    ks2, vs2 = wire.decode_pages(meta, arrays)
    for p, k, v in zip((5, 9), ks2, vs2):
        dst.write_page(p, k, v)
    torch.cuda.synchronize()
    assert (dst.k_pages.data_ptr(), dst.v_pages.data_ptr()) == ptrs
    for a, b in ((3, 5), (7, 9)):
        assert torch.equal(dst.k_pages[:, b], src.k_pages[:, a])
        assert torch.equal(dst.v_pages[:, b], src.v_pages[:, a])
    others = [p for p in range(dst.num_pages) if p not in (5, 9)]
    assert torch.equal(dst.k_pages[:, others], keep[0][:, others])
    assert torch.equal(dst.v_pages[:, others], keep[1][:, others])


def test_import_prefix_rolls_back_on_card_under_forced_failure(cuda):
    """``PrefixCache.import_prefix`` into a card pool whose second page
    write dies: every staged page goes back to the free list, nothing is
    indexed, the books balance; the same import then succeeds and serves
    the pages bit for bit."""
    from paddle_tpu_torch.kvcache.cache import PrefixCache
    src = _card_pool(cuda, torch.bfloat16)
    table = src.allocate("a", 48)
    src.k_pages.copy_(torch.randn(src.k_pages.shape, device=cuda).to(
        torch.bfloat16))
    src.v_pages.copy_(torch.randn(src.v_pages.shape, device=cuda).to(
        torch.bfloat16))
    ks, vs = zip(*(src.export_page(p) for p in table))
    dst = _card_pool(cuda, torch.bfloat16)
    cache = PrefixCache(dst)
    # the free LIST is the rollback's point  # tpu-lint: disable=private-kvcache
    free0 = sorted(dst._free)
    real, calls = dst.write_page, [0]

    def dying(page, k, v):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("transfer died mid-page")
        real(page, k, v)

    dst.write_page = dying
    tokens = list(range(1, 49))
    with pytest.raises(RuntimeError, match="mid-page"):
        cache.import_prefix(tokens, list(ks), list(vs))
    # tpu-lint: disable=private-kvcache
    assert sorted(dst._free) == free0 and len(cache.tree) == 0
    dst.check_conservation()
    dst.write_page = real
    out = cache.import_prefix(tokens, list(ks), list(vs))
    assert out["imported_pages"] == 3
    dst.check_conservation()
    shared, n_cached, _ = cache.lookup(tokens + [7])
    assert n_cached == 48
    torch.cuda.synchronize()
    for p_dst, p_src in zip(shared, table):
        assert torch.equal(dst.k_pages[:, p_dst], src.k_pages[:, p_src])
        assert torch.equal(dst.v_pages[:, p_dst], src.v_pages[:, p_src])


def _fleet_streams(cfg, params, prompts, cuda, mode, unified=True,
                   samplers=None):
    """Two replicas on the card: ``"plain"`` and ``"failover"`` behind
    ``FleetRouter`` (replica 0 dies at the first step where one of its
    requests is mid-decode), ``"handoff"`` behind ``DisaggRouter`` (a
    PREFILL and a DECODE replica, every request's settled pages handed
    over). Returns the streams, the tokens each request held when its
    stream moved, and the moved request ids."""
    from paddle_tpu_torch.resilience import Fault, FaultInjector
    from paddle_tpu_torch.serving import (DisaggRouter, FleetRouter,
                                          HealthConfig, ReplicaHandle,
                                          ReplicaRole)
    inj = FaultInjector()
    handles = [ReplicaHandle(i, _fleet_engine(cfg, cuda, unified),
                             health_config=HealthConfig(eject_after=1))
               for i in range(2)]
    if mode == "handoff":
        router = DisaggRouter(handles, roles={0: ReplicaRole.PREFILL,
                                              1: ReplicaRole.DECODE})
    else:
        router = FleetRouter(handles, fault_injector=inj)
    reqs = [router.submit(p, sampler=None if samplers is None
                          else samplers[i]) for i, p in enumerate(prompts)]
    moved_at = {}
    if mode == "handoff":
        real = router._handoff

        def noted(req, src, dst):
            moved_at[req.rid] = list(req.stream.tokens)
            return real(req, src, dst)
        router._handoff = noted
    while router.pending:
        if mode == "failover" and not moved_at and any(
                r.replica_id == 0 and 0 < len(r.stream.tokens) < 24
                for r in reqs):
            moved_at = {r.rid: list(r.stream.tokens) for r in reqs
                        if r.replica_id == 0}
            inj.schedule.append(Fault("replica_die", router._steps + 1,
                                      replica=0))
        router.step(params)
    assert all(r.state == "done" for r in reqs)
    for h in handles:
        h.engine.mgr.check_conservation()
        assert h.engine.mgr.num_live_pages == 0
    moved = [r.rid for r in reqs if r.rid in moved_at
             and (r.failovers or mode == "handoff")]
    return [r.stream.tokens for r in reqs], moved_at, moved


def _fleet_engine(cfg, cuda, unified=True):
    return D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=24), num_slots=4,
        page_size=16, max_seq_len=160, chunk=4, step_tokens=64,
        prefix_cache=True, device=cuda, unified=unified)


@pytest.mark.parametrize("mode", ["failover", "handoff"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_replica_failover_on_card_against_single_engine(cuda, dtype,
                                                            mode):
    """A stream that moves between two replicas on the card, by a replica
    killed mid-decode (``failover``) or by the prefill -> decode page
    handoff (``handoff``): every request finishes, the tokens streamed
    before the move equal a single engine's greedy streams, and so does
    every token after it (the reference's promise). The destination
    prefills tokens that the uninterrupted run decoded; the router's
    ``decoded`` count flags them, so at bf16 too each takes the route it
    was decoded on and the streams are equal bit for bit."""
    _check_moved_streams(cuda, dtype, mode, unified=True)


@pytest.mark.parametrize("mode", ["failover", "handoff"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_legacy_two_replica_failover_on_card_against_single_engine(
        cuda, dtype, mode):
    """The same moves between legacy replicas (``unified=False``): the
    destination prefills only the given prompt (flash forward, row 5)
    and forces the streamed tokens through its decode chunk one a step
    (paged decode, row 4), as the uninterrupted run decoded them, so at
    bf16 too the streams are equal bit for bit."""
    _check_moved_streams(cuda, dtype, mode, unified=False)


@pytest.mark.parametrize("mode", ["failover", "handoff"])
def test_two_replica_sampled_failover_on_card_against_single_engine(cuda,
                                                                    mode):
    """Seeded sampled streams (temperature 0.8, top-k 50; the seed pinned
    at submit) that move at bf16 equal a single engine's bit for bit:
    the draw is keyed by position, the logits are the uninterrupted
    run's."""
    _check_moved_streams(cuda, torch.bfloat16, mode, unified=True,
                         sampled=True)


def _serve_with(eng, params, prompts, samplers):
    rids = [eng.submit(p, sampler=s) for p, s in zip(prompts, samplers)]
    done = {}
    while len(done) < len(rids):
        eng.step(params)
        done.update(eng.collect())
    return [done[r] for r in rids]


def _check_moved_streams(cuda, dtype, mode, unified, sampled=False):
    cfg = L.llama_tiny(hidden_size=512, num_attention_heads=8,
                       num_key_value_heads=8, intermediate_size=1024,
                       num_hidden_layers=2, dtype=dtype)
    params = L.init_params(cfg, seed=5, device=cuda)
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(20, 120, size=8)]
    samplers = None
    if sampled:
        samplers = [SamplerConfig(temperature=0.8, top_k=50, seed=100 + i)
                    for i in range(len(prompts))]
        oracle = _serve_with(_fleet_engine(cfg, cuda, unified), params,
                             prompts, samplers)
    else:
        oracle = _fleet_engine(cfg, cuda, unified).serve(params, prompts)
    plain, _, _ = _fleet_streams(cfg, params, prompts, cuda, "plain",
                                 unified, samplers)
    assert plain == oracle
    got, moved_at, moved = _fleet_streams(cfg, params, prompts, cuda, mode,
                                          unified, samplers)
    assert moved
    for rid, toks in moved_at.items():
        assert toks == oracle[rid][:len(toks)]
    after = [(got[r][len(moved_at[r]):], oracle[r][len(moved_at[r]):])
             for r in moved]
    same = [a == b for x, y in after for a, b in zip(x, y)]
    assert got == oracle, (f"{sum(same)} of {len(same)} tokens after the "
                           f"move equal ({len(moved)} requests moved)")


# ---------------------------------------------------------------------------
# GPT slice: the kernels at GPT-2 XL's shapes, the model card vs CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4096, 1600), (8, 1600), (3, 37, 1600)])
def test_layer_norm_kernels_match_plain_at_gpt2_xl_width(cuda, dtype, shape):
    """h 1600 (GPT-2 XL), eps 1e-5: not a power of two, so the forward's
    2048-wide block and the backward's tiles end in masked columns; the
    forward and backward within LN_TOL of the plain versions, and the
    backward's dw and db the same bits at every launch."""
    test_layer_norm_kernels_match_plain(cuda, dtype, shape, 1e-5)
    test_layer_norm_bwd_repeats_bitwise_at_every_launch(cuda, dtype, shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,s", [(100, 1024), (200, 512), (50, 37),
                                  (25, 639)])
def test_flash_kernels_match_plain_at_gpt2_xl_heads(cuda, dtype, bh, s):
    """Causal flash at d 64 over GPT-2 XL's 25 heads a sequence: the
    training step's (4·25, 1024), the prefill's (8·25, 512), a 37-token
    prompt and the 639-token re-forward of phase 26."""
    test_flash_kernels_match_plain(cuda, dtype, (bh, s, s, 64, True, 1,
                                                 None))


def test_gpt_on_card_matches_cpu(cuda):
    """Tiny GPT (h 128, 2 heads of 64, 2 layers, fp32): logits, greedy
    ``generate`` tokens and one ``compute_loss`` step's gradients on the
    card against the same weights on the CPU, under CARD_CPU_TOL; the
    forward launches 2L + 1 LayerNorms and L flash forwards."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.testing import CARD_CPU_TOL, key_bias_split
    cfg = G.gpt_tiny(hidden_size=128, num_attention_heads=2,
                     intermediate_size=256)
    cpu = G.init(G.GPTForCausalLM(cfg, device="cpu"), 3)
    card = G.GPTForCausalLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 29)))
    before = (ln.layer_norm.launches, fa.flash_fwd_kernel.launches)
    with torch.no_grad():
        got = card(ids.to(cuda))
        torch.cuda.synchronize()
    assert (ln.layer_norm.launches - before[0],
            fa.flash_fwd_kernel.launches - before[1]) == (5, 2)
    rtol, atol = CARD_CPU_TOL["out"]
    with torch.no_grad():
        torch.testing.assert_close(got.cpu(), cpu(ids), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(card.generate(ids[:, :9], 10),
                                  cpu.generate(ids[:, :9], 10))
    labels = torch.roll(ids, -1, dims=1)
    for model, dev in ((card, cuda), (cpu, "cpu")):
        model.compute_loss(ids.to(dev), labels.to(dev)).backward()
    grads = dict(card.named_parameters())
    for name, p in cpu.named_parameters():
        # the key bias's true gradient is 0: both sides hold noise there
        gk, got = key_bias_split(name, grads[name].grad.cpu(), 128)
        wk, want = key_bias_split(name, p.grad, 128)
        if gk is not None:
            assert gk.abs().max() < 1e-5 and wk.abs().max() < 1e-5, name
        rms_close(got, want, 1e-3, 1e-4, name)


# ---------------------------------------------------------------------------
# the training recipe's eager API: optimizers, clips, the loss scaler
# ---------------------------------------------------------------------------

_FAMILIES = {
    "sgd": ("SGD", dict(weight_decay=0.01)),
    "momentum": ("Momentum", dict(momentum=0.9, use_nesterov=True)),
    "adam": ("Adam", dict(weight_decay=0.01)),
    "adamw": ("AdamW", dict(weight_decay=0.01)),
    "adamax": ("Adamax", dict(weight_decay=0.01)),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.01)),
    "rmsprop": ("RMSProp", dict(centered=True, momentum=0.5)),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
}
_SHAPES = [(64, 48), (48,), (3, 5, 7), (1000,)]


def _grad_seq(steps, seed=0):
    rng = np.random.RandomState(seed)
    return [[torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in _SHAPES] for _ in range(steps)]


def _twin(cls, kw, cuda, clip=None, dtype=torch.float32, **extra):
    """The same optimizer over the same weights on the card and on the
    CPU."""
    from paddle_tpu_torch import optimizer as O
    rng = np.random.RandomState(1)
    vals = [torch.from_numpy((0.5 * rng.randn(*s)).astype(np.float32))
            for s in _SHAPES]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ps = [(f"w{i}", torch.nn.Parameter(v.to(dev, dtype, copy=True)))
              for i, v in enumerate(vals)]
        out[dev.type] = (ps, getattr(O, cls)(
            learning_rate=1e-2, parameters=ps,
            grad_clip=None if clip is None else clip(), **kw, **extra))
    return out


def _drive_twin(twin, grads):
    for gs in grads:
        for ps, opt in twin.values():
            for (_, p), g in zip(ps, gs):
                p.grad = g.to(p.device, p.dtype)
            opt.step()


def _twin_close(twin, rtol=1e-4, atol=1e-5):
    """Weights and every state slot, card against CPU (``CARD_CPU_TOL``'s
    bound: the same gradients, so only the two devices' fp32 rounding of
    a scalar division or a norm's sum differ)."""
    (cps, copt), (hps, hopt) = twin["cuda"], twin["cpu"]
    for (name, a), (_, b) in zip(cps, hps):
        torch.testing.assert_close(a.detach().cpu().float(),
                                   b.detach().float(), rtol=rtol, atol=atol,
                                   msg=name)
        assert set(copt.state[name]) == set(hopt.state[name])
        for k, v in hopt.state[name].items():
            torch.testing.assert_close(copt.state[name][k].cpu(), v,
                                       rtol=rtol, atol=atol,
                                       msg=f"{name}.{k}")


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_optimizer_family_on_card_matches_cpu(cuda, family):
    """Five steps of each family from the same gradients (a cosine
    schedule behind a warm-up, the global-norm clip): the card's weights
    and state slots are the CPU's within ``CARD_CPU_TOL["out"]``."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.optimizer import lr as LR
    from paddle_tpu_torch.testing import CARD_CPU_TOL
    cls, kw = _FAMILIES[family]
    twin = _twin(cls, kw, cuda, clip=lambda: O.ClipGradByGlobalNorm(1.0))
    scheds = []
    for _, opt in twin.values():
        opt._learning_rate = LR.LinearWarmup(
            LR.CosineAnnealingDecay(1e-2, 10), 2, 1e-3, 1e-2)
        scheds.append(opt._learning_rate)
    for gs in _grad_seq(5):
        _drive_twin(twin, [gs])
        for sc in scheds:
            sc.step()
    _twin_close(twin, *CARD_CPU_TOL["out"])


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_classes_on_card_match_cpu(cuda, clip, dtype):
    """Each clip class over the same gradients on the card and the CPU:
    the clipped gradients agree to fp32 rounding (bf16: one rounding
    step), a ``need_clip = False`` parameter passes through untouched,
    and the global norm stays a 0-d tensor on the card (no host read)."""
    from paddle_tpu_torch import optimizer as O
    make = {"value": lambda: O.ClipGradByValue(0.5),
            "norm": lambda: O.ClipGradByNorm(0.7),
            "global_norm": lambda: O.ClipGradByGlobalNorm(1.5)}[clip]
    grads = [3 * g for g in _grad_seq(1, seed=4)[0]]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ps = [torch.nn.Parameter(torch.zeros(g.shape, device=dev))
              for g in grads]
        ps[1].need_clip = False
        pairs = [(p, g.to(dev, dtype)) for p, g in zip(ps, grads)]
        got = make()(pairs)
        assert got[1][1] is pairs[1][1]
        out[dev.type] = [g for _, g in got]
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-6)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == dtype
        torch.testing.assert_close(a.cpu().float(), b.float(), **tol)
    norm = O.ClipGradByGlobalNorm.global_norm(
        [g.to(cuda) for g in grads])
    assert norm.device.type == "cuda" and norm.dim() == 0


def test_grad_scaler_skips_an_inf_step_bitwise_on_card(cuda):
    """bf16 parameters, AdamW with fp32 masters, ``GradScaler``: a good
    step, then one whose gradient holds an inf: no weight, master or
    moment moves (bitwise), the step count stays, the scale halves, and
    the scaler reads the card once a step."""
    from paddle_tpu_torch import amp as A
    twin = _twin("AdamW", dict(multi_precision=True), cuda,
                 dtype=torch.bfloat16)
    ps, opt = twin["cuda"]
    scaler = A.GradScaler(init_loss_scaling=2.0 ** 8,
                          decr_every_n_nan_or_inf=1)
    for k, gs in enumerate(_grad_seq(2, seed=2)):
        for (_, p), g in zip(ps, gs):
            p.grad = (g * scaler.get_loss_scaling()).to(cuda, torch.bfloat16)
        if k == 1:
            ps[2][1].grad.view(-1)[4] = float("inf")
            before = [p.detach().clone() for _, p in ps]
            state = {n: {s: v.clone() for s, v in d.items()}
                     for n, d in opt.state.items()}
        scaler.step(opt)
        scaler.update()
    assert all(torch.equal(a, p.detach()) for a, (_, p) in zip(before, ps))
    assert all(torch.equal(state[n][s], opt.state[n][s])
               for n in state for s in state[n])
    assert opt.step_count == 1 and scaler.get_loss_scaling() == 2.0 ** 7
    assert scaler.host_reads == 2


@pytest.mark.parametrize("family", ["adamw", "lamb", "momentum"])
def test_state_dict_resume_on_card_is_bitwise(cuda, family):
    """Three steps; the state (with a scheduler's) through host memory
    into a fresh optimizer over fresh parameters on the card; two more
    steps give the uninterrupted run's bits."""
    from paddle_tpu_torch.optimizer import lr as LR
    cls, kw = _FAMILIES[family]
    grads = _grad_seq(5, seed=3)

    def run(twin, grads):
        ps, opt = twin["cuda"]
        for gs in grads:
            for (_, p), g in zip(ps, gs):
                p.grad = g.to(cuda, p.dtype)
            opt.step()
            opt._learning_rate.step()
        return ps, opt

    def make():
        twin = _twin(cls, dict(kw, multi_precision=cls != "Momentum"), cuda,
                     dtype=torch.bfloat16 if cls != "Momentum"
                     else torch.float32)
        twin["cuda"][1]._learning_rate = LR.CosineAnnealingDecay(1e-2, 8)
        return twin

    ps, opt = run(make(), grads[:3])
    saved = {k: (v.detach().to("cpu", copy=True)
                 if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state_dict().items()}
    weights = [p.detach().to("cpu", copy=True) for _, p in ps]
    run({"cuda": (ps, opt)}, grads[3:])
    twin2 = make()
    ps2, opt2 = twin2["cuda"]
    with torch.no_grad():
        for (_, p), w in zip(ps2, weights):
            p.copy_(w)
    opt2.set_state_dict(saved)
    run(twin2, grads[3:])
    for (_, a), (_, b) in zip(ps, ps2):
        assert torch.equal(a, b)
    for name in opt.state:
        for k, v in opt.state[name].items():
            assert torch.equal(v, opt2.state[name][k]), (name, k)



# ---------------------------------------------------------------------------
# multi-host serving on the card
# ---------------------------------------------------------------------------

def test_spawned_host_on_card_matches_in_process_engine(cuda):
    """A host process spawned by ``PipeTransport`` builds the default
    host on the card (one head of 64: the kernels' head dims are 64 and
    128): its ``hello`` describes the in-process engine of the same
    factory, and its greedy tokens equal that engine's."""
    from paddle_tpu_torch import serving as S
    from paddle_tpu_torch.serving.multihost import llama_tiny_host
    kw = {"max_new_tokens": 8, "max_seq_len": 48, "device": "cuda",
          "num_attention_heads": 1}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, (int(n),)).astype(np.int32)
               for n in (5, 9, 13)]
    eng, params = llama_tiny_host(**kw)
    want = eng.serve(params, prompts)
    h = S.HostHandle(0, S.HostEndpoint(S.PipeTransport(factory_kwargs=kw),
                                       timeout_s=300.0))
    try:
        f = h.engine
        assert (f.kv_dtype, f.page_size, f.max_seq_len, f.page_nbytes,
                f.mgr.usable_pages, f.has_prefix_cache) == (
            "float32", eng.page_size, eng.max_seq_len, eng.mgr.page_nbytes,
            eng.mgr.usable_pages, True)
        mirrors = [h.submit(p) for p in prompts]
        for _ in range(200):
            if all(m.done for m in mirrors):
                break
            h.step(None)
        assert [m.state for m in mirrors] == ["done"] * 3
        assert [list(m.stream.tokens) for m in mirrors] == want
    finally:
        h.close()
    assert not h.endpoint.transport.alive()


def test_host_export_import_of_bf16_pages_is_bitwise_on_card(cuda):
    """``export_flight`` at one host and ``import_prefix`` at another
    move bf16 KV pages through the wire frames bit for bit, tagged
    ``bfloat16``."""
    from paddle_tpu_torch import serving as S
    cfg = L.llama_tiny(num_hidden_layers=2, num_attention_heads=1,
                       num_key_value_heads=1, dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=4, device=cuda)
    servers, hosts = [], []
    for i in range(2):
        eng = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=12), num_slots=2,
            page_size=4, max_seq_len=48, chunk=2, prefix_cache=True,
            device=cuda)
        servers.append(S.HostServer(eng, params, host_id=i))
        hosts.append(S.HostHandle(i, S.HostEndpoint(
            S.LocalTransport(servers[-1]))))
    assert hosts[0].engine.kv_dtype == "bfloat16"
    mirror = hosts[0].submit(np.arange(1, 20, dtype=np.int32))
    for _ in range(4):
        hosts[0].step(None)
    tokens, ks, vs = hosts[0].export_flight(mirror)
    assert ks and len(ks) == len(vs)
    src = servers[0].engine
    erid = servers[0]._reqs[mirror.rid].engine_rid
    src_pages = src.mgr.sequence_pages(erid)[:len(ks)]
    got = hosts[1].import_prefix(tokens, ks, vs)
    assert got["imported_pages"] == len(ks)
    dst = servers[1].engine
    dst.mgr.check_conservation()
    dst_pages = [n.page for n in dst.cache.tree.match(tokens, touch=False)]
    assert len(dst_pages) == len(ks)
    for a, b in zip(src_pages, dst_pages):
        for pool in ("k_pages", "v_pages"):
            pa_ = getattr(src.mgr, pool)[:, a].view(torch.int16)
            pb_ = getattr(dst.mgr, pool)[:, b].view(torch.int16)
            assert torch.equal(pa_, pb_)


# ---------------------------------------------------------------------------
# the Paddle-shaped Tensor surface on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card_place(cuda):
    from paddle_tpu_torch.core import place as tplace
    prev = tplace._current_place[0]
    tplace._current_place[0] = None          # the default place
    yield
    tplace._current_place[0] = prev


def test_default_place_is_the_card(card_place):
    import paddle_tpu_torch as TP
    t = TP.to_tensor([1.0, 2.0])
    assert t.place == TP.CUDAPlace(0) and t._value.is_cuda
    assert TP.get_device() == "gpu:0"
    assert TP.randn([3]).place == TP.CUDAPlace(0)


def test_tensor_path_launches_the_kernels(card_place):
    """Tensors through F.rms_norm and causal SDPA launch rows 1, 2, 5 and
    6 (fp32 and under auto_cast O1), never the plain versions."""
    import paddle_tpu_torch as TP
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp
    TP.seed(0)
    for level in (None, "O1"):
        x = TP.Parameter(TP.randn([2, 64, 4, 64]))
        g = TP.Parameter(TP.ones([64]))
        counts = [rn.rms_norm, rn.rms_norm_bwd, fa.flash_fwd_kernel,
                  fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel]
        before = [c.launches for c in counts]
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            y = F.rms_norm(x, g, 1e-5)
            o = F.scaled_dot_product_attention(y, y, y, is_causal=True)
        assert o.dtype == (torch.bfloat16 if level else torch.float32)
        o.astype("float32").sum().backward()
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counts, before)] == [1] * 5
        assert x.grad is not None and torch.isfinite(x.grad._value).all()


def test_random_draws_on_card_equal_the_cpu(card_place):
    import paddle_tpu_torch as TP
    got = {}
    for dev in ("gpu", "cpu"):
        TP.set_device(dev)
        TP.seed(3)
        got[dev] = [t.numpy() for t in (
            TP.rand([5, 7]), TP.uniform([9], min=-2.0, max=3.0),
            TP.randint(0, 100, [11]), TP.bernoulli(TP.full([13], 0.4)),
            TP.randperm(50), TP.multinomial(TP.to_tensor([0.2, 0.8]), 4,
                                            replacement=True))]
    for a, b in zip(got["gpu"], got["cpu"]):
        np.testing.assert_array_equal(a, b)


def test_eager_script_on_card_matches_cpu(card_place):
    """scripts/eager_llama_step.py at tiny widths, fp32: the card's loss
    and every gradient against the CPU's (``EAGER_CARD_CPU_TOL``)."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch.testing import EAGER_CARD_CPU_TOL, close
    from scripts import eager_llama_step as ES
    S = ES.surface("paddle_tpu_torch")
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=4,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2)
    stacked = {k: v.numpy() for k, v in
               L.init_params(cfg, 0, device="cpu").items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 100))
    labels = np.roll(ids, -1, axis=-1)
    runs = {}
    for dev in ("gpu", "cpu"):
        TP.set_device(dev)
        params = ES.make_parameters(S, stacked, cfg.num_hidden_layers)
        cos, sin = ES.rope_tables(S, 100, 64)
        loss = ES.forward_backward(S, params, TP.to_tensor(ids),
                                   TP.to_tensor(labels), cfg, cos, sin)
        runs[dev] = (loss._value.detach().cpu(),
                     {k: p.grad._value.cpu() for k, p in params.items()})
    tol = EAGER_CARD_CPU_TOL["fp32"]
    close(runs["gpu"][0], runs["cpu"][0], *tol["loss"], "loss")
    for k, g in runs["cpu"][1].items():
        l2_close(runs["gpu"][1][k], g, tol["grads"], k)


def _tiny_gpt_recipe(seed):
    """A tiny GPT on the card (h 128, 2 heads of 64, 2 layers) under the
    training recipe: O2 bf16 with fp32 masters, AdamW over a warm-up and
    cosine schedule, the global-norm clip and the loss scaler."""
    from paddle_tpu_torch import amp as A
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.optimizer import lr as LR
    model = G.init(G.GPTForCausalLM(G.gpt_tiny(
        hidden_size=128, num_attention_heads=2, intermediate_size=256),
        device="cuda"), seed)
    named = list(model.named_parameters())
    sched = LR.LinearWarmup(LR.CosineAnnealingDecay(1e-3, 10), 2, 1e-4,
                            1e-3)
    opt = O.AdamW(learning_rate=sched, parameters=named,
                  grad_clip=O.ClipGradByGlobalNorm(1.0))
    scaler = A.GradScaler(enable=True)
    model, opt = A.decorate(models=model, optimizers=opt, level="O2",
                            dtype="bfloat16")
    return model, named, sched, opt, scaler


def test_resilient_trainer_on_card_resumes_bitwise(cuda, tmp_path):
    """Phase 32's schedule at tiny widths on the card: a preemption at
    step 2 with its flush truncated, a resume by fresh objects from
    another seed, a NaN at step 4 rolled back; the final weights,
    masters, moments and scheduler state equal a plain run's bit for
    bit, through pinned snapshots and loads back onto the card."""
    from paddle_tpu_torch import resilience as R
    from paddle_tpu_torch.distributed.checkpoint import TrainState

    def step_fn(objs, fi=None):
        model, _, sched, opt, scaler = objs

        def step(i):
            if fi is not None and fi.fire("nan", i):
                return float("nan")
            rng = np.random.RandomState(100 + i)
            ids = torch.from_numpy(rng.randint(0, 128, (2, 64))).cuda()
            model.zero_grad(set_to_none=True)
            loss = model.compute_loss(ids, torch.roll(ids, -1, 1))
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            sched.step()
            return loss.detach()
        return step

    def state(objs):
        _, named, sched, opt, _ = objs
        return ([p.detach().cpu() for _, p in named]
                + [opt.state[n][k].cpu() for n, _ in named
                   for k in sorted(opt.state[n])], sched.state_dict())

    plain = _tiny_gpt_recipe(0)
    run = step_fn(plain)
    for i in range(6):
        run(i)
    want = state(plain)
    fi = R.FaultInjector([R.Fault("preempt", 2), R.Fault("truncate_shard", 3),
                          R.Fault("nan", 4)])
    cfg = R.ResilienceConfig(checkpoint_dir=str(tmp_path / "ck"),
                             save_interval=2, keep=2, fault_injector=fi)
    metrics = R.ResilienceMetrics()
    objs = _tiny_gpt_recipe(0)
    with pytest.raises(R.Preempted) as ei:
        R.ResilientTrainer(TrainState(objs[0], objs[3], objs[2]), cfg,
                           metrics).run(step_fn(objs, fi), 6)
    assert ei.value.step == 3
    objs = _tiny_gpt_recipe(1)
    res = R.ResilientTrainer(TrainState(objs[0], objs[3], objs[2]), cfg,
                             metrics).run(step_fn(objs, fi), 6)
    assert res["resumed_from"] == 2 and res["end_step"] == 6
    assert {k: metrics.get(k) for k in (
        "preemptions", "preempt_flushes", "corrupt_checkpoints_skipped",
        "nan_rollbacks", "restores")} == dict(
        preemptions=1, preempt_flushes=1, corrupt_checkpoints_skipped=1,
        nan_rollbacks=1, restores=2)
    got = state(objs)
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# nn, metric and hapi (Transformer-base's path)
# ---------------------------------------------------------------------------

def test_nn_families_on_card_match_cpu(card_place):
    """Each family of nn.functional this slice ports, on the card
    against the CPU (chip_smoke phase 33 (a)'s check)."""
    import chip_smoke
    worst = chip_smoke.nn_families_card_cpu(torch)
    assert set(worst) >= {"activations", "dropout", "conv", "pool", "norm",
                          "resize", "loss", "attention", "rnn"}


def test_transformer_mt_tiny_on_card_matches_cpu(card_place):
    """scripts/transformer_mt.py at its tiny widths: three fit steps with
    dropout, greedy tokens and beam ids, card against CPU."""
    import chip_smoke
    rep = chip_smoke.mt_parity_phase(torch, ln)
    assert rep["beam_ids_equal"] and len(rep["losses_card"]) == 3


def test_attention_routes_on_card(card_place):
    """Without a mask or dropout, nn attention launches the flash
    forward; with a padding mask it takes the masked path (no launch);
    Accuracy stays on the card."""
    import paddle_tpu_torch as TP
    TP.seed(0)
    mha = TP.nn.MultiHeadAttention(128, 2)
    x = TP.randn([2, 5, 128])
    before = fa.flash_fwd_kernel.launches
    mha(x)
    assert fa.flash_fwd_kernel.launches == before + 1
    mask = TP.to_tensor(np.zeros((2, 1, 1, 5), np.float32))
    mha(x, attn_mask=mask)
    assert fa.flash_fwd_kernel.launches == before + 1
    c = TP.metric.Accuracy().compute(x, TP.zeros([2, 5], dtype="int32"))
    assert c.is_cuda


# ---------------------------------------------------------------------------
# compiled programs: jit, static, the Predictor, fusion
# ---------------------------------------------------------------------------

def test_jit_programs_on_card_match_graphs_off_and_cpu(card_place):
    """Every CUDA graph of ``to_static``, ``TrainStep`` / ``multi_step``,
    dy2static functions and the Predictor equals the same program with
    graphs off on the card, bitwise, and the CPU within MT_FIT; the saved
    programs launch rows 8, 1 and 5 (by their counters); the fused-tail
    streams and the fused Adam are bitwise (chip_smoke phase 34 (a))."""
    import chip_smoke
    rep = chip_smoke.jit_parity_phase(torch, L, D, ln, rn, fa)
    assert rep["graph_breaks"] > 0
    assert rep["saved_programs"]["llama_block"]["launches"] == dict(
        rms_norm_fwd=8, flash_attention_fwd=4, layer_norm_fwd=0)
    assert rep["saved_programs"]["mlp"]["launches"]["layer_norm_fwd"] == 4


def test_to_static_python_numbers_replay_with_new_values(card_place):
    """A compiled function called with Python numbers: one capture for
    the signature, and each call computes with its own values, equal to
    the graphs-off run on the card bitwise and to the CPU."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import jit

    def f(x, s, n):
        return x * s + n

    x = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    calls = ((2.0, 1), (3.0, 1), (2.0, 4), (-0.25, 0))
    runs = {}
    for graphs in (True, False):
        sf = jit.to_static(f)
        sf._graphs = graphs
        runs[graphs] = ([sf(TP.to_tensor(x), s, n)._value for s, n in calls],
                        sf.programs.captures)
    assert runs[True][1] == 1 and runs[False][1] == 0
    for a, b, (s, n) in zip(runs[True][0], runs[False][0], calls):
        assert a.is_cuda and torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), torch.from_numpy(x * s + n),
                                   rtol=0, atol=0)


_FUSED_FAMILIES = {
    "sgd": lambda O, ps: O.SGD(0.01, parameters=ps, weight_decay=0.01),
    "momentum": lambda O, ps: O.Momentum(0.01, 0.9, parameters=ps,
                                         use_nesterov=True),
    "adam": lambda O, ps: O.Adam(0.003, parameters=ps, weight_decay=0.01),
    "adamw": lambda O, ps: AdamW(0.01, parameters=ps, weight_decay=0.05),
    "adamax": lambda O, ps: O.Adamax(0.01, parameters=ps),
    "lamb": lambda O, ps: O.Lamb(0.01, parameters=ps),
    "rmsprop": lambda O, ps: O.RMSProp(0.01, centered=True, momentum=0.9,
                                       parameters=ps),
    "adagrad": lambda O, ps: O.Adagrad(0.01, parameters=ps),
}


@pytest.mark.parametrize("family", sorted(_FUSED_FAMILIES))
def test_fused_optimizer_bitwise_on_card(cuda, family):
    """The fused optimizer step (one CUDA graph, host scalars staged as
    the eager kernels receive them) commits the eager step's bits, with
    a global-norm clip and parameters of other learning rates."""
    from paddle_tpu_torch.jit import install_optimizer_fusion
    from paddle_tpu_torch.optimizer import clip as Cl
    from paddle_tpu_torch.optimizer import optimizer as O
    runs = []
    for fused in (False, True):
        gen = torch.Generator().manual_seed(0)
        named = []
        for i, s in enumerate(((256, 64), (64,), (4096, 8), (3, 5, 7))):
            p = torch.randn(s, generator=gen).to(cuda).requires_grad_(True)
            if i % 2:
                p.optimize_attr = {"learning_rate": 0.5}
            named.append((f"p_{i}", p))
        opt = _FUSED_FAMILIES[family](O, named)
        opt._grad_clip = Cl.ClipGradByGlobalNorm(1.0)
        if fused:
            install_optimizer_fusion(opt)
        for k in range(4):
            g = torch.Generator().manual_seed(10 + k)
            for _, p in named:
                p.grad = torch.randn(p.shape, generator=g).to(cuda)
            opt.step()
        runs.append(([p.detach().clone() for _, p in named],
                     {n: {k: v.clone() for k, v in s.items()}
                      for n, s in opt.state.items()}))
    (pe, se), (pf, sf) = runs
    for a, b in zip(pe, pf):
        assert torch.equal(a, b)
    for n in se:
        for k in se[n]:
            assert torch.equal(se[n][k], sf[n][k]), (n, k)


def test_model_fit_jit_compile_tiny_mt_graph_equals_graphs_off(card_place):
    """``Model.prepare(jit_compile=True)`` on the tiny Transformer: the
    compiled steps (one graph per padded signature) equal the TrainStep
    body run with graphs off on the card, bitwise."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import transformer_mt as M
    S = M.surface("paddle_tpu_torch")
    cfg = dict(M.TINY)
    pairs = M.sentence_pairs(24, cfg["vocab"], 5, 12, seed=0)
    batches = [M.bucket_batch(S, *M.collate(pairs[i:i + 4]),
                              buckets=dict(rows=(4, 8), trg=(16,),
                                           src=(16,)))
               for i in range(0, 24, 4)]
    runs = []
    for graphs in (True, False):
        S.paddle.seed(0)
        net = M.build_model(S, cfg)
        model = M.prepare(S, net, cfg, jit_compile=True)
        model._train_step._graphs = graphs
        losses = [model.train_batch([s, t], [l])[0] for s, t, l in batches]
        runs.append((losses, [p.detach().clone()
                              for p in net.parameters()],
                     model._train_step.programs.captures))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert runs[0][2] == 1 and runs[1][2] == 0


def test_capture_failure_raises(cuda):
    """A body that reads the card on the host captures nothing: the
    capture's error is raised, with no eager fallback (run in its own
    process, so the failed capture cannot disturb the other tests)."""
    import subprocess
    import sys
    code = (
        "import torch, paddle_tpu_torch as P\n"
        "from paddle_tpu_torch import jit\n"
        "def f(x):\n"
        "    return x * float(x._value.sum().cpu())\n"
        "sf = jit.to_static(f)\n"
        "for _ in range(2):\n"
        "    try:\n"
        "        sf(P.to_tensor([1.0, 2.0]))\n"
        "        print('no error')\n"
        "    except Exception as e:\n"
        "        print('raised', type(e).__name__)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.splitlines()
    # the second call warms up and captures again: it fails as the first
    # did, not on the entry the failed capture left
    assert len(lines) == 2 and all(ln.startswith("raised") for ln in lines), \
        (proc.stdout, proc.stderr[-2000:])
    assert "AttributeError" not in proc.stdout
