"""Card-only tests of the PyTorch/CUDA port: each kernel against its
plain PyTorch version at Llama-2-7B widths, the wrappers' argument
checks, the serving engine and the training step on the card against
the same on the CPU, and the training step's launch counts. Marked ``gpu``; they skip where no CUDA device is present. Run on
the card (the machine there has no JAX, so skip the conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Whether a card exists is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import decoding as D
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import rms_norm as rn

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


# (rtol, atol as a share of the plain tensor's rms, most relative L2
# error), per tensor, so that small outputs are held as tightly as large
# gradients (chip_smoke.py's FLASH_TOL). fp32: summation order and the
# online vs one-pass softmax. bf16: each output is one bf16 rounding (two
# steps of rtol), and P or dS, rounded to bf16 on both sides, now and then
# rounds the other way and moves a small output by several of its steps
_FLASH_TOL = {torch.bfloat16: (2 ** -6, 2 ** -4, 2 ** -7),
              torch.float32: (1e-4, 1e-3, 1e-5)}


def _flash_close(got, want, dtype, msg):
    rtol, rel_atol, l2_tol = _FLASH_TOL[dtype]
    wf = want.float()
    atol = rel_atol * wf.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got.float(), wf, rtol=rtol, atol=atol,
                               msg=msg)
    assert ((got.float() - wf).norm() / wf.norm()).item() <= l2_tol, msg

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
    _flash_close(out, pout, dtype, "out")
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert torch.isfinite(got.float()).all(), name
        _flash_close(got, want, dtype, name)


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
    # losses: fp32 sums in other orders. Weights: AdamW divides each
    # gradient element by its own running RMS, so an element within the
    # two devices' rounding noise takes a noisy direction and its weight
    # may differ by up to 2·lr a step; all but a 1e-4 share of the
    # elements agree to (rtol 1e-4, atol 1e-5)
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-6)
    outside = total = 0
    for k in params:
        diff = (runs[0][1][k] - runs[1][1][k]).abs()
        assert diff.max().item() <= 2 * 1e-3 * 3, k
        outside += int((diff > 1e-5 + 1e-4 * runs[1][1][k].abs()).sum())
        total += diff.numel()
    assert outside <= 1e-4 * total


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
