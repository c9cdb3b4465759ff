"""Card-only tests of the PyTorch/CUDA port: each kernel against its
plain PyTorch version at Llama-2-7B and BERT-large widths, the wrappers'
argument checks, the serving engine and the Llama and ERNIE training
steps on the card against the same on the CPU, and the training steps'
launch counts. Marked ``gpu``; they skip where no CUDA device is
present. Run on the card (the machine there has no JAX, so skip the
conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Whether a card exists is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import decoding as D
from paddle_tpu_torch.models import ernie as E
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import layer_norm_fused as ln
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import rms_norm as rn
from paddle_tpu_torch.testing import (LN_TOL, LSE_TOL, flash_close, rms_close,
                                      trained_weights_close)

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


def _mixed_batch(cuda, dtype, nh, nkv, d=128, page=16, width=8):
    """Decode rows, a cold and a warm prefill row, an idle row, pads."""
    rng = np.random.RandomState(1)
    rows = [(99, 1), (40, 1), (0, 30), (64, 17)]      # (first position, n)
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
    gen = torch.Generator(device=cuda).manual_seed(2)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    v = torch.randn(pool, generator=gen, device=cuda).to(dtype)
    q = torch.randn((len(tr), nh, d), generator=gen, device=cuda).to(dtype)
    meta = [torch.as_tensor(np.asarray(a, np.int32), device=cuda)
            for a in (bt, tr, pos, kv_lens)]
    return (q, k, v, *meta)


# fp32: summation order and online vs two-pass softmax. bf16: the plain
# version rounds the probabilities to bf16 before P·V (the JAX array
# path's rounding); the kernel keeps them in fp32 (the Pallas kernel's)
_ATTN_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("nh,nkv,d", [(32, 32, 128), (32, 8, 128),
                                      (8, 2, 64)])
def test_ragged_attention_kernel_matches_plain(cuda, dtype, nh, nkv, d):
    args = _mixed_batch(cuda, dtype, nh, nkv, d)
    before = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    want = pa.ragged_paged_attention_plain(*args)
    rtol, atol = _ATTN_TOL.get(dtype, (2e-2, 2e-2))
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    pads = args[4] < 0
    assert bool((got[pads] == 0).all())


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
# (bh, sq, sk, d, causal, kv_rep, kv_valid)
_FLASH_CASES = [(8, 300, 300, 128, True, 1, None),
                (8, 256, 256, 128, True, 4, None),
                (4, 256, 256, 128, True, 1, 200),
                (4, 130, 130, 128, False, 2, None),
                (4, 64, 200, 128, True, 1, None),
                (6, 200, 200, 64, True, 3, None)]


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
                                   (600, 256)])
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


# (bh, s, d, causal, kv_rep, rows of segment ids; 0 = one shared row)
_SEG_CASES = [(8, 300, 64, False, 1, 2), (6, 256, 128, True, 1, 0),
              (16, 512, 64, False, 1, 4), (8, 200, 64, True, 2, 2)]


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
