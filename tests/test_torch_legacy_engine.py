"""The legacy serving pipeline (``ContinuousBatchingEngine(unified=False)``)
and the prefix cache on both pipelines: the PyTorch port against the JAX
package's engines, with the JAX package's weights carried across through
numpy. Greedy tokens must be identical, request for request; the port
runs on the CPU, in fp32 (the two pipelines sum attention in different
orders, so only fp32 holds them to identical tokens)."""

import numpy as np
import pytest

from paddle_tpu.inference.decoding import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

STORM_LENS = (5, 12, 3, 9, 17, 2, 7, 30)


def _weights(seed=3):
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    jparams = JL.init_stacked_params(jcfg, seed=seed)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    params = TL.params_from_numpy({k: np.asarray(v)
                                   for k, v in jparams.items()}, cfg, "cpu")
    return jcfg, jparams, cfg, params


W = _weights()


def _jax_engine(max_new=6, eos=None, **geo):
    return JEngine(W[0], JGen(max_new_tokens=max_new, eos_token_id=eos),
                   **{**dict(num_slots=2, page_size=4, max_seq_len=64,
                             chunk=3), **geo})


def _port_engine(max_new=6, eos=None, **geo):
    return TD.ContinuousBatchingEngine(
        W[2], TD.GenerationConfig(max_new_tokens=max_new, eos_token_id=eos),
        device="cpu", **{**dict(num_slots=2, page_size=4, max_seq_len=64,
                                chunk=3), **geo})


def _prompts(n, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, (int(lens[i % len(lens)]),))
            .astype(np.int32) for i in range(n)]


def _storm(prefix_cache):
    """test_unified_step's storm; with the cache, shared prefixes and an
    exact repeat (the COW wave: a full-prompt match copies the final
    page)."""
    prompts = _prompts(8, STORM_LENS, seed=1)
    if prefix_cache:
        prompts[3] = np.concatenate([prompts[1], prompts[2]])
        prompts[5] = prompts[1].copy()
    return prompts


def test_legacy_storm_identical_to_jax_legacy_engine():
    """Ragged lengths and slot reuse through 2 slots, 3 decode steps per
    chunk, prefill waves of 1 and 2 rows: tokens and checksums."""
    prompts = _storm(False)
    jeng = _jax_engine(unified=False)
    teng = _port_engine(unified=False)
    want = jeng.serve(W[1], prompts)
    assert teng.serve(W[3], prompts) == want
    for rid in range(len(prompts)):
        assert teng.finished_checksum(rid) == jeng.finished_checksum(rid)
    teng.mgr.check_conservation()
    assert teng.mgr.num_free_pages == teng.mgr.usable_pages
    assert teng.prefill_calls > 0 and teng.decode_steps > 0
    assert teng.micro_rounds == 0


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_unified_byte_identical_to_legacy(prefix_cache):
    """tests/test_unified_step.py's gate, in the port: the unified engine
    emits exactly the legacy pipeline's greedy tokens (and both equal
    the JAX legacy engine's)."""
    prompts = _storm(prefix_cache)
    legacy = _port_engine(unified=False, prefix_cache=prefix_cache)
    unified = _port_engine(unified=True, prefix_cache=prefix_cache)
    got_legacy = legacy.serve(W[3], prompts)
    assert unified.serve(W[3], prompts) == got_legacy
    jeng = _jax_engine(unified=False, prefix_cache=prefix_cache)
    assert got_legacy == jeng.serve(W[1], prompts)
    for eng in (legacy, unified):
        eng.mgr.check_conservation()
        cached = eng.mgr.num_cached_pages if prefix_cache else 0
        assert eng.mgr.num_free_pages + cached == eng.mgr.usable_pages


@pytest.mark.parametrize("unified", [True, False])
def test_prefix_cache_identical_to_jax_with_warm_wave(unified):
    """A cold wave of shared-system-prompt requests, then a warm wave of
    the same prompts (full-prompt hits: COW rows) and new suffixes
    (shared-prefix hits): tokens, the prefill tokens actually run, and
    the cache's hit/COW counters equal the JAX engine's."""
    rng = np.random.RandomState(4)
    system = rng.randint(1, 256, (12,)).astype(np.int32)
    cold = [np.concatenate([system, rng.randint(1, 256, (n,))])
            .astype(np.int32) for n in (4, 5, 8)]
    # 16 and 20 tokens: whole pages, so their repeats copy-on-write
    warm = [cold[0], cold[2]] + [
        np.concatenate([system, rng.randint(1, 256, (n,))]).astype(np.int32)
        for n in (6, 1)]
    geo = dict(unified=unified, prefix_cache=True, num_slots=3)
    jeng, teng = _jax_engine(**geo), _port_engine(**geo)
    for wave in (cold, warm):
        assert teng.serve(W[3], wave) == jeng.serve(W[1], wave)
        assert teng._prefill_tokens == jeng._prefill_tokens
    snap, jsnap = teng.cache.snapshot(), jeng.cache.snapshot()
    for key in ("hits", "misses", "cow_copies", "cached_tokens",
                "cached_pages", "tree_nodes", "evictions"):
        assert snap[key] == jsnap[key], key
    assert snap["hits"] >= 4 and snap["cow_copies"] >= 2
    skipped = sum(map(len, cold + warm)) - teng._prefill_tokens
    assert skipped == snap["cached_tokens"] > 0
    assert teng.cache.gauges == {"free": teng.mgr.num_free_pages,
                                 "live": 0,
                                 "cached": teng.mgr.num_cached_pages}


@pytest.mark.parametrize("max_new", [7, 8])
def test_over_decoding_past_the_table_with_the_cache(max_new):
    """A request with prompt + budget == max_seq_len (== the table span)
    whose last decode chunk runs past the span (chunk 3 does not divide
    the budget), the cache on, then a repeat of its prompt (a cache hit)
    and a shared-prefix request. Tokens equal the JAX legacy engine's,
    and every pool page from 1 on does too: the over-decoded writes never
    land on a row's own slots (JAX drops them, the port sends them to
    page 0)."""
    rng = np.random.RandomState(7)
    p = rng.randint(1, 256, (32 - max_new,)).astype(np.int32)
    q = rng.randint(1, 256, (5,)).astype(np.int32)
    prompts = [p, q, p.copy(), np.concatenate([p[:12], q])]
    geo = dict(unified=False, prefix_cache=True, max_seq_len=32)
    jeng = _jax_engine(max_new=max_new, **geo)
    teng = _port_engine(max_new=max_new, **geo)
    assert teng._table_width * 4 == 32 and max_new % 3
    assert teng.serve(W[3], prompts) == jeng.serve(W[1], prompts)
    assert teng.cache.snapshot()["hits"] == jeng.cache.snapshot()["hits"] > 0
    np.testing.assert_allclose(teng.mgr.k_pages.numpy()[:, 1:],
                               np.asarray(jeng.mgr.k_pages)[:, 1:],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(teng.mgr.v_pages.numpy()[:, 1:],
                               np.asarray(jeng.mgr.v_pages)[:, 1:],
                               rtol=1e-4, atol=1e-5)


def test_legacy_mid_decode_admission_with_cache_identical_to_jax():
    """A request admitted while others are mid-decode gets its own
    prefill wave; both engines run in lockstep (the port audits its page
    books after every step) and deliver the same tokens."""
    geo = dict(unified=False, prefix_cache=True)
    jeng, teng = _jax_engine(**geo), _port_engine(**geo)
    early = _prompts(2, (11, 4), seed=5)
    late = np.concatenate([early[0][:8], _prompts(1, (3,), seed=9)[0]])
    for eng in (jeng, teng):
        for p in early:
            eng.submit(p)
    jeng.step(W[1])
    teng.step(W[3])
    assert all(len(r.tokens) > 0 for r in teng._live.values())
    assert jeng.submit(late) == teng.submit(late) == 2
    got, want = {}, {}
    for _ in range(30):
        jeng.step(W[1])
        teng.step(W[3])
        want.update(jeng.collect())
        got.update(teng.collect())
        if len(got) == 3 and len(want) == 3:
            break
    assert got == want and set(got) == {0, 1, 2}


def test_legacy_eos_stops_like_jax():
    prompts = _prompts(4, (6, 13, 3, 9), seed=2)
    free_run = _port_engine(max_new=8, unified=False).serve(W[3], prompts)
    eos = free_run[1][2]                    # a token the model emits
    want = _jax_engine(max_new=8, eos=eos, unified=False).serve(W[1],
                                                                 prompts)
    assert any(len(w) < 8 for w in want)
    got = _port_engine(max_new=8, eos=eos, unified=False).serve(W[3],
                                                                 prompts)
    assert got == want


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_legacy_cancel_queued_and_live(prefix_cache):
    teng = _port_engine(unified=False, prefix_cache=prefix_cache)
    prompts = _prompts(3, (5, 9, 4), seed=6)
    rids = [teng.submit(p) for p in prompts]
    assert teng.cancel(rids[2])             # queued: dropped
    teng.step(W[3])
    assert teng.cancel(rids[1])             # live: retired, pages freed
    teng.mgr.check_conservation()
    while teng.step(W[3]):
        pass
    out = teng.collect()
    assert set(out) == {rids[0]} and len(out[rids[0]]) == 6
    assert teng.finished_checksum(rids[1]) is None
    assert not teng.cancel(rids[1])
    if prefix_cache:       # only the finished row's full blocks are cached
        assert teng.cache.snapshot()["tree_nodes"] == (5 + 6) // 4
    else:
        assert teng.mgr.num_free_pages == teng.mgr.usable_pages


def test_legacy_pad_rows_and_idle_slots_stay_finite():
    """A wave of 3 admissions pads to 4 rows (one pad row into page 0);
    idle slots decode at position 0 through an all-zero table. Their
    outputs are dropped, but the carry they leave stays a valid token."""
    teng = _port_engine(unified=False, num_slots=4, max_new=4)
    prompts = _prompts(3, (5, 9, 4), seed=8)
    assert teng.serve(W[3], prompts) == _jax_engine(
        unified=False, num_slots=4, max_new=4).serve(W[1], prompts)
    assert teng.prefill_calls == 1
    tok = teng._tok_dev.numpy()
    assert np.all((tok >= 0) & (tok < 256))
