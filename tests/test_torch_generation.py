"""The generate engines of the PyTorch port against the JAX package on the
CPU: the contiguous-cache model functions (``models.llama.init_kv_cache``,
``_cached_attention``, ``prefill_stacked``, ``decode_step_stacked``),
``GenerationEngine`` / ``llama_engine`` (greedy and sampled tokens, the
full re-forward oracle, one program per ``generation_engine.run`` key)
and ``PagedGenerationEngine``'s ``paged_engine.run`` program. Inputs are
made with numpy from a seed and the JAX package's weights carried across
through numpy; fp32, tiny widths (2 layers). The card's side (CUDA
graphs, launch counts) is in tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import decoding as JD
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

# two layers of products, norms and softmax summed in different orders by
# XLA and PyTorch (tests/test_torch_legacy_model.py's bound)
STEP = dict(rtol=1e-4, atol=1e-5)
#: the prefill flags every prefill program's key ends with (A8W8 on, the
#: two routing flags the port fixes)
FLAGS = (True, True, True)


def _weights(seed, nkv=4):
    jcfg = JL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    cfg = TL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    jparams = JL.init_stacked_params(jcfg, seed=seed)
    params = TL.params_from_numpy({k: np.asarray(v)
                                   for k, v in jparams.items()}, cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("nkv,dtype", [(4, None), (2, torch.bfloat16)])
def test_init_kv_cache_and_kvcache(nkv, dtype):
    """(L, B, S_max, nkv, d) zeros, as the JAX function's, in the config's
    dtype or the one asked for; ``KVCache.seq_capacity`` reads S_max."""
    jcfg = JL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    cfg = TL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    want = JL.init_kv_cache(jcfg, 3, 40)
    got = TL.init_kv_cache(cfg, 3, 40, dtype=dtype, device="cpu")
    assert set(got) == {"k", "v"}
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape) == (
            2, 3, 40, nkv, cfg.head_dim)
        assert t.dtype == (dtype or cfg.dtype) and not t.any()
    assert TI.KVCache(got).seq_capacity == 40
    assert TI.KVCache({}).seq_capacity == 0


@pytest.mark.parametrize("nkv", [4, 2, 1], ids=["mha", "gqa2", "mqa"])
@pytest.mark.parametrize("t,kv_len", [(1, 1), (1, 17), (1, 24), (5, 5),
                                      (5, 20), (8, 24)])
def test_cached_attention_matches_jax(nkv, t, kv_len):
    """T query tokens at positions kv_len-T .. kv_len-1 over a 24-slot
    cache (keys past kv_len hold data the mask must hide); ``kv_len`` as
    an int and as a 0-d tensor."""
    rng = np.random.RandomState(t * 31 + kv_len)
    cfg = TL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    jcfg = JL.llama_tiny(num_hidden_layers=2, num_key_value_heads=nkv)
    d = cfg.head_dim
    q = rng.randn(2, t, 4, d).astype(np.float32)
    kc = rng.randn(2, 24, nkv, d).astype(np.float32)
    vc = rng.randn(2, 24, nkv, d).astype(np.float32)
    want = np.asarray(JL._cached_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_len, jnp.int32), jcfg))
    for kl in (kv_len, torch.tensor(kv_len)):
        got = TL._cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), kl, cfg)
        assert got.shape == (2, t, 4, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nkv", [4, 2])
def test_prefill_and_decode_steps_match_jax(nkv):
    """A right-padded bucket of 16 prefilled into a 24-slot cache, then
    three decode steps at positions 16, 17, 18: logits at every step
    and both caches; the port's cache is updated in place."""
    jcfg, jparams, cfg, params = _weights(1, nkv)
    rng = np.random.RandomState(2)
    ids = rng.randint(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    jcache = JL.init_kv_cache(jcfg, 2, 24)
    tcache = TL.init_kv_cache(cfg, 2, 24, device="cpu")
    jl, jcache = JL.prefill_stacked(jparams, jnp.asarray(ids), jcache, jcfg)
    tl, out = TL.prefill_stacked(params, torch.from_numpy(ids), tcache, cfg)
    assert out is tcache
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **STEP)
    for pos in (16, 17, 18):
        tok = rng.randint(1, cfg.vocab_size, (2,)).astype(np.int32)
        jl, jcache = JL.decode_step_stacked(jparams, jnp.asarray(tok),
                                            jnp.asarray(pos, jnp.int32),
                                            jcache, jcfg)
        tl, _ = TL.decode_step_stacked(params, torch.from_numpy(tok),
                                       torch.tensor(pos, dtype=torch.int32),
                                       tcache, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **STEP)


@pytest.mark.parametrize("nkv,seed", [(4, 3), (2, 5)], ids=["mha", "gqa"])
def test_llama_engine_greedy_matches_jax_and_reforward(nkv, seed):
    """``llama_engine`` greedy tokens equal the JAX engine's, and equal
    the argmax over a full re-forward of the growing sequence
    (tests/test_inference.py's oracle, through the port's
    ``forward_stacked``)."""
    jcfg, jparams, cfg, params = _weights(seed, nkv)
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, cfg.vocab_size, (2, 5)).astype(np.int32)
    want = JD.llama_engine(jcfg, JD.GenerationConfig(
        max_new_tokens=6)).generate(jparams, prompt)
    eng = TI.llama_engine(cfg, TI.GenerationConfig(max_new_tokens=6),
                          device="cpu")
    got = eng.generate(params, prompt)
    assert got.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    seq = torch.from_numpy(prompt)
    ref = []
    for _ in range(6):
        with torch.no_grad():
            logits = TL.forward_stacked(params, seq, cfg)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1).int()
        ref.append(nxt.numpy())
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got, np.stack(ref, axis=1))


@pytest.mark.parametrize("gen", [
    dict(temperature=0.8, seed=11),
    dict(temperature=0.7, top_k=20, seed=3),
    dict(temperature=1.2, top_p=0.9, seed=4),
    dict(temperature=0.9, top_k=30, top_p=0.8, seed=0)],
    ids=["temperature", "top_k", "top_p", "all"])
def test_llama_engine_do_sample_matches_jax(gen):
    """``do_sample``: ``key(seed)``, one split for the prefill's token and
    one a step, each draw ``_sample``'s temperature -> top-k -> top-p
    and categorical: the JAX engine's tokens bit for bit."""
    jcfg, jparams, cfg, params = _weights(7)
    prompt = np.random.RandomState(1).randint(
        1, cfg.vocab_size, (3, 9)).astype(np.int32)
    conf = dict(max_new_tokens=7, do_sample=True, **gen)
    want = JD.llama_engine(jcfg, JD.GenerationConfig(**conf)).generate(
        jparams, prompt)
    got = TI.llama_engine(cfg, TI.GenerationConfig(**conf),
                          device="cpu").generate(params, prompt)
    np.testing.assert_array_equal(got, want)
    greedy = TI.llama_engine(cfg, TI.GenerationConfig(max_new_tokens=7),
                             device="cpu").generate(params, prompt)
    assert not np.array_equal(got, greedy)


def test_generation_miss_records_match_jax(monkeypatch):
    """The JAX engine's ``recompiles.record_miss`` calls (names, keys
    with the flags) over: two prompt lengths in one bucket (one
    miss; each length its own tokens), another bucket, and a new
    ``generation_config`` (programs dropped, one miss)."""
    jcfg, jparams, cfg, params = _weights(3)
    want = []
    monkeypatch.setattr(JD.recompiles, "record_miss",
                        lambda name, key: want.append((name, key)))
    rng = np.random.RandomState(4)
    calls = [(rng.randint(1, cfg.vocab_size, (2, n)).astype(np.int32), g)
             for n, g in ((5, None), (9, None), (20, None),
                          (9, dict(max_new_tokens=3)))]
    jeng = JD.llama_engine(jcfg, JD.GenerationConfig(max_new_tokens=4))
    teng = TI.llama_engine(cfg, TI.GenerationConfig(max_new_tokens=4),
                           device="cpu")
    for ids, g in calls:
        jout = jeng.generate(jparams, ids, None if g is None
                             else JD.GenerationConfig(**g))
        tout = teng.generate(params, ids, None if g is None
                             else TI.GenerationConfig(**g))
        np.testing.assert_array_equal(tout, jout)
    assert [n for n, _ in want] == ["generation_engine.run"] * 3
    assert teng.compile_misses == want
    assert teng.compile_misses == [
        ("generation_engine.run", (16, 4, 2) + FLAGS),
        ("generation_engine.run", (32, 4, 2) + FLAGS),
        ("generation_engine.run", (16, 3, 2) + FLAGS)]
    assert set(teng.compile_seconds) == {"generation_engine.run"}
    assert teng.capture_seconds == {"generation_engine.run": 0.0}


def test_generation_engine_takes_a_kvcache_and_new_weights():
    """An ``init_cache`` that returns a ``KVCache``; new weights on the
    same engine rebuild the program (a counted miss, the same key) and
    give the tokens of an engine that only saw them."""
    _, _, cfg, params = _weights(3)
    other = _weights(6)[3]
    prompt = np.random.RandomState(5).randint(
        1, cfg.vocab_size, (2, 6)).astype(np.int32)
    gen = TI.GenerationConfig(max_new_tokens=4)
    eng = TI.GenerationEngine(
        lambda p, i, c: TL.prefill_stacked(p, i, c, cfg),
        lambda p, t, pos, c: TL.decode_step_stacked(p, t, pos, c, cfg),
        lambda b, s: TI.KVCache(TL.init_kv_cache(cfg, b, s, device="cpu")),
        gen, device="cpu")
    first = eng.generate(params, prompt)
    np.testing.assert_array_equal(first, TI.llama_engine(
        cfg, gen, device="cpu").generate(params, prompt))
    swapped = eng.generate(other, prompt)
    assert eng.compile_misses == [
        ("generation_engine.run", (16, 4, 2) + FLAGS)] * 2
    np.testing.assert_array_equal(swapped, TI.llama_engine(
        cfg, gen, device="cpu").generate(other, prompt))
    assert not np.array_equal(first, swapped)


@pytest.mark.parametrize("gen", [dict(), dict(do_sample=True,
                                              temperature=0.8, top_k=20,
                                              top_p=0.9, seed=11)],
                         ids=["greedy", "sampled"])
def test_paged_engine_program_per_key_matches_jax(monkeypatch, gen):
    """``PagedGenerationEngine``: two calls of one key ``(t_bucket,
    max_new, b, width)`` (other prompts, the same bucket and widest
    table) build one program and give the JAX engine's tokens each; a
    call of another key builds a second, and both programs stay (on the
    CPU each call runs over a new pool, every page free after it). The
    miss records equal the JAX engine's ``paged_engine.run`` records,
    the flags included."""
    jcfg, jparams, cfg, params = _weights(9)
    want = []
    monkeypatch.setattr(JD.recompiles, "record_miss",
                        lambda name, key: want.append((name, key)))
    rng = np.random.RandomState(7)
    batches = [[rng.randint(1, cfg.vocab_size, n).astype(np.int32)
                for n in lens]
               for lens in ((3, 6, 5, 20), (9, 2, 20, 7), (3, 6, 5, 40))]
    conf = dict(max_new_tokens=5, **gen)
    jeng = JD.PagedGenerationEngine(jcfg, JD.GenerationConfig(**conf),
                                    page_size=4)
    teng = TI.PagedGenerationEngine(cfg, TI.GenerationConfig(**conf),
                                    page_size=4, device="cpu")
    for prompts in batches:
        np.testing.assert_array_equal(teng.generate(params, prompts),
                                      jeng.generate(jparams, prompts))
    assert teng.compile_misses == want
    assert teng.compile_misses == [
        ("paged_engine.run", (32, 5, 4, 7) + FLAGS),
        ("paged_engine.run", (64, 5, 4, 12) + FLAGS)]
    assert len(teng._compiled) == 2
    teng._mgr.check_conservation()
    assert teng._mgr.num_free_pages == teng._mgr.usable_pages
