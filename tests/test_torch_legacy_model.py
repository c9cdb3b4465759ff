"""The legacy paged model functions of the PyTorch port
(``models.llama.prefill_paged``, ``prefill_paged_suffix``,
``decode_step_paged``) and ``PagedGenerationEngine`` against the JAX
package on the same numpy inputs, with the JAX package's weights carried
across through numpy. The port runs on the CPU (its plain kernel
versions); fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.inference.decoding import PagedGenerationEngine as JPaged
from paddle_tpu.models import llama as JL
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# two layers of products, norms and softmax summed in different orders by
# XLA and PyTorch (the same bound as tests/test_torch_llama.py's step)
STEP = dict(rtol=1e-4, atol=1e-5)
PAGE, NPAGES = 4, 40


def _setup(seed=0, nkv=4):
    jcfg = JL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    cfg = TL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    params = {k: np.asarray(v) for k, v in
              JL.init_stacked_params(jcfg, seed=seed).items()}
    rng = np.random.RandomState(seed)
    pool = (2, NPAGES, PAGE, nkv, cfg.head_dim)
    kp = rng.randn(*pool).astype(np.float32)
    vp = rng.randn(*pool).astype(np.float32)
    return jcfg, cfg, params, kp, vp, rng


def _tables(lens):
    mgr = tpa.PagedKVCacheManager(1, NPAGES, PAGE, 1, 1, device="cpu")
    for sid, n in enumerate(lens):
        mgr.allocate(sid, n)
    bt, _ = mgr.block_tables(list(range(len(lens))))
    return bt.astype(np.int32)


def _run(jfn, tfn, params, cfg, arrays, kp, vp, bt):
    """The JAX function and the port's on the same inputs; the port's
    pools are updated in place and returned."""
    jout = jfn({k: jnp.asarray(v) for k, v in params.items()},
               *(jnp.asarray(a) for a in arrays), jnp.asarray(kp),
               jnp.asarray(vp), jnp.asarray(bt))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = tfn(TL.params_from_numpy(params, cfg, device="cpu"),
               *(torch.from_numpy(a) for a in arrays), tk, tv,
               torch.from_numpy(bt))
    assert tout[1] is tk and tout[2] is tv
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


@pytest.mark.parametrize("seed,nkv", [(0, 4), (1, 2)])
def test_prefill_paged_matches_jax(seed, nkv):
    """A right-padded ragged wave (lengths 6, 16, 1, and a pad row of
    one token with an all-zero table) at bucket 16: logits at every
    position of the real rows, and both pools from page 1 on (page 0
    takes every pad token's K/V, in an order neither side fixes)."""
    jcfg, cfg, params, kp, vp, rng = _setup(seed, nkv)
    lens = np.array([6, 16, 1, 1], np.int32)
    bt = _tables([6, 16, 1])
    bt = np.concatenate([bt, np.zeros((1, bt.shape[1]), np.int32)])
    ids = rng.randint(1, cfg.vocab_size, (4, 16)).astype(np.int32)
    (jl, jk, jv), (tl, tk, tv) = _run(
        lambda p, i, s, k, v, b: JL.prefill_paged(p, i, s, k, v, b, jcfg),
        lambda p, i, s, k, v, b: TL.prefill_paged(p, i, s, k, v, b, cfg),
        params, cfg, (ids, lens), kp, vp, bt)
    assert tl.shape == (4, 16, cfg.vocab_size)
    for r, n in enumerate(lens[:3]):
        np.testing.assert_allclose(tl[r, :n], jl[r, :n], **STEP)
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **STEP)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], **STEP)


def test_prefill_paged_bucket_wider_than_the_table():
    """A 16-token bucket over a 3-page (12-token) table: the pad tokens
    past the table's span go to page 0 on both sides."""
    jcfg, cfg, params, kp, vp, rng = _setup(2)
    lens = np.array([9, 5], np.int32)
    bt = _tables([12, 5])
    ids = rng.randint(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    (jl, jk, _), (tl, tk, _) = _run(
        lambda p, i, s, k, v, b: JL.prefill_paged(p, i, s, k, v, b, jcfg),
        lambda p, i, s, k, v, b: TL.prefill_paged(p, i, s, k, v, b, cfg),
        params, cfg, (ids, lens), kp, vp, bt)
    np.testing.assert_allclose(tl[0, :9], jl[0, :9], **STEP)
    np.testing.assert_allclose(tl[1, :5], jl[1, :5], **STEP)
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **STEP)


@pytest.mark.parametrize("seed,nkv", [(0, 4), (3, 2)])
def test_prefill_paged_suffix_matches_jax(seed, nkv):
    """Warm rows (cached prefixes of 8 and 5 tokens, random K/V in their
    pages) and a cold row (start 0) in one suffix wave, plus a pad row."""
    jcfg, cfg, params, kp, vp, rng = _setup(seed, nkv)
    lens = np.array([5, 3, 7, 1], np.int32)
    starts = np.array([8, 5, 0, 0], np.int32)
    bt = _tables([13, 8, 7])
    bt = np.concatenate([bt, np.zeros((1, bt.shape[1]), np.int32)])
    ids = rng.randint(1, cfg.vocab_size, (4, 16)).astype(np.int32)
    (jl, jk, jv), (tl, tk, tv) = _run(
        lambda p, i, s, st, k, v, b: JL.prefill_paged_suffix(
            p, i, s, st, k, v, b, jcfg),
        lambda p, i, s, st, k, v, b: TL.prefill_paged_suffix(
            p, i, s, st, k, v, b, cfg),
        params, cfg, (ids, lens, starts), kp, vp, bt)
    for r, n in enumerate(lens[:3]):
        np.testing.assert_allclose(tl[r, :n], jl[r, :n], **STEP)
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **STEP)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], **STEP)


def _decode_inputs(seed, nkv):
    jcfg, cfg, params, kp, vp, rng = _setup(seed, nkv)
    # rows at positions 8 (page start), 3 (page end), 10, and an idle slot
    # (position 0 over an all-zero table, as the engine's idle slots)
    bt = _tables([9, 4, 11])
    bt = np.concatenate([bt, np.zeros((1, bt.shape[1]), np.int32)])
    tok = rng.randint(1, cfg.vocab_size, (4,)).astype(np.int32)
    positions = np.array([8, 3, 10, 0], np.int32)
    return jcfg, cfg, params, kp, vp, bt, tok, positions


def _decode(jcfg, cfg, params, kp, vp, bt, tok, positions):
    return _run(
        lambda p, t, pos, k, v, b: JL.decode_step_paged(p, t, pos, k, v, b,
                                                        jcfg),
        lambda p, t, pos, k, v, b: TL.decode_step_paged(p, t, pos, k, v, b,
                                                        cfg),
        params, cfg, (tok, positions), kp, vp, bt)


@pytest.mark.parametrize("seed,nkv", [(0, 4), (1, 2), (2, 1)])
def test_decode_step_paged_matches_jax(seed, nkv):
    """Logits of every row (the idle one included: finite on both sides)
    and both pools from page 1 on."""
    (jl, jk, jv), (tl, tk, tv) = _decode(*_decode_inputs(seed, nkv))
    assert tl.shape == (4, 256) and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, **STEP)
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **STEP)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], **STEP)


def test_decode_step_paged_matches_jax_pallas_kernel_path(monkeypatch):
    """The same step with the JAX side's attention through the Pallas
    decode kernel (interpret mode): the whole pools, page 0 included,
    agree."""
    real = jpa.paged_attention_pallas
    monkeypatch.setattr(
        jpa, "paged_attention",
        lambda q, kp, vp, bt, sl, scale=None: real(q, kp, vp, bt, sl, scale,
                                                   interpret=True))
    (jl, jk, jv), (tl, tk, tv) = _decode(*_decode_inputs(4, 2))
    np.testing.assert_allclose(tl, jl, **STEP)
    np.testing.assert_allclose(tk, jk, **STEP)
    np.testing.assert_allclose(tv, jv, **STEP)


def test_decode_step_past_the_table():
    """A row over-decoding past the table span (position 20 over a
    4-page table): JAX drops its write and gives it NaN logits; the port
    writes into page 0, keeps its logits finite, and every other row and
    every page from 1 on equal JAX's."""
    jcfg, cfg, params, kp, vp, bt, tok, positions = _decode_inputs(5, 2)
    positions = positions.copy()
    positions[1] = bt.shape[1] * PAGE + 4
    (jl, jk, jv), (tl, tk, tv) = _decode(jcfg, cfg, params, kp, vp, bt, tok,
                                         positions)
    assert np.all(np.isnan(jl[1])) and np.all(np.isfinite(tl))
    keep = [0, 2, 3]
    np.testing.assert_allclose(tl[keep], jl[keep], **STEP)
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **STEP)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], **STEP)


@pytest.mark.parametrize("max_new,page", [(5, 4), (1, 4), (6, 16)])
def test_paged_generation_engine_matches_jax(max_new, page):
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    jp = JL.init_stacked_params(jcfg, seed=9)
    tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              cfg, "cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 6, 5, 20)]
    want = JPaged(jcfg, JGen(max_new_tokens=max_new),
                  page_size=page).generate(jp, prompts)
    got = TD.PagedGenerationEngine(cfg, TD.GenerationConfig(
        max_new_tokens=max_new), page_size=page, device="cpu").generate(
            tp, prompts)
    assert got.shape == (4, max_new) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_paged_generation_engine_refuses_sampling():
    """``do_sample`` is ported (the sampling slice): each draw takes the
    next key of the JAX engine's ``jax.random.split`` chain from
    ``key(seed)``, so the sampled tokens equal the JAX engine's."""
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    jp = JL.init_stacked_params(jcfg, seed=9)
    tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              cfg, "cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 6, 5, 20)]
    gen = dict(max_new_tokens=6, do_sample=True, temperature=0.8,
               top_k=20, top_p=0.9, seed=11)
    want = JPaged(jcfg, JGen(**gen), page_size=4).generate(jp, prompts)
    got = TD.PagedGenerationEngine(cfg, TD.GenerationConfig(**gen),
                                   page_size=4, device="cpu").generate(
                                       tp, prompts)
    np.testing.assert_array_equal(got, want)
    greedy = TD.PagedGenerationEngine(cfg, TD.GenerationConfig(
        max_new_tokens=6), page_size=4, device="cpu").generate(tp, prompts)
    assert not np.array_equal(got, greedy)
