"""Speculative decoding in the PyTorch port (``speculative=True``) on the
CPU: drafters, verification in one ragged step, paged growth and
rollback (``grow_to`` / ``truncate_pages``, also under the prefix
cache), against the port's own non-speculative engine and the JAX
package's speculative engine, with JAX-made weights."""

import numpy as np
import pytest
import torch

from paddle_tpu.inference.decoding import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.inference.sampling import SamplerConfig as JSampler
from paddle_tpu.inference.speculative import DraftModel as JDraftModel
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference.sampling import SamplerConfig
from paddle_tpu_torch.inference.speculative import (DraftModel, Drafter,
                                                    NgramDrafter)
from paddle_tpu_torch.kvcache import RefcountedKVCacheManager
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.paged_attention import PagedKVCacheManager
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

JCFG = JL.llama_tiny(num_hidden_layers=2)
JPARAMS = JL.init_stacked_params(JCFG, seed=0)
CFG = TL.llama_tiny(num_hidden_layers=2)
PARAMS = TL.params_from_numpy({k: np.asarray(v) for k, v in JPARAMS.items()},
                              CFG, "cpu")


def _prompts(n=6, lens=(4, 12), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size,
                        (int(rng.randint(*lens)),)).astype(np.int32)
            for _ in range(n)]


def _engine(max_new=16, num_slots=2, page_size=16, max_seq_len=64, **kw):
    return TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(max_new_tokens=max_new),
        num_slots=num_slots, page_size=page_size, max_seq_len=max_seq_len,
        chunk=2, device="cpu", **kw)


def _jengine(max_new=16, num_slots=2, page_size=16, max_seq_len=64, **kw):
    return JEngine(JCFG, JGen(max_new_tokens=max_new), num_slots=num_slots,
                   page_size=page_size, max_seq_len=max_seq_len, chunk=2,
                   **kw)


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_prompt_lookup():
    d = NgramDrafter(max_ngram=3, min_ngram=1)
    assert d.draft([7, 8, 9, 1, 2, 7, 8], 3) == [9, 1, 2]
    assert d.draft([1, 2, 3, 1, 2, 5, 9, 1, 2], 1) == [5]
    assert d.draft([1, 2, 3, 8, 4, 3, 9, 1, 2, 3], 1) == [8]
    assert d.draft([1, 2, 3, 4], 2) == []
    assert NgramDrafter(max_ngram=3, min_ngram=2).draft(
        [5, 1, 2, 3, 5], 2) == []
    assert NgramDrafter(max_ngram=3, min_ngram=1).draft(
        [5, 1, 2, 3, 5], 2) == [1, 2]
    assert d.draft([4, 4, 4], 2) == [4]
    assert d.draft([1, 9, 1], 5) == [9, 1]
    with pytest.raises(ValueError):
        NgramDrafter(max_ngram=0)


def test_draft_model_drafts_the_jax_draft_models_chain():
    """The port's DraftModel over the same weights drafts the JAX
    DraftModel's greedy chain, and plugs into the engine unchanged."""
    dm = DraftModel(PARAMS, CFG, window=32)
    hist = [3, 7, 11, 2]
    got = dm.draft(hist, 3)
    assert got == JDraftModel(JPARAMS, JCFG, window=32).draft(hist, 3)
    eng = _engine(max_new=6, speculative=True, spec_k=2, drafter=dm)
    ref = _engine(max_new=6).serve(PARAMS, _prompts(2))
    assert eng.serve(PARAMS, _prompts(2)) == ref
    st = eng.spec.snapshot()
    assert st["drafted"] > 0 and st["acceptance_ratio"] > 0.8


# ---------------------------------------------------------------------------
# byte identity: speculative on/off, and the JAX speculative engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [False, True])
def test_spec_byte_identical_greedy(prefix_cache):
    """Greedy output is byte-identical speculative on/off (cache off and
    on: warm suffixes and COW rows ride the speculative rounds) and equal
    to the JAX speculative engine's, with the same draft statistics."""
    prompts = _prompts(6)
    ref = _engine(prefix_cache=prefix_cache).serve(PARAMS, prompts)
    eng = _engine(prefix_cache=prefix_cache, speculative=True, spec_k=4)
    out = eng.serve(PARAMS, prompts)
    assert out == ref
    assert eng.spec.stats["drafted"] > 0
    jeng = _jengine(prefix_cache=prefix_cache, speculative=True, spec_k=4)
    assert [list(o) for o in jeng.serve(JPARAMS, prompts)] == out
    assert jeng.spec.stats == eng.spec.stats


def test_spec_byte_identical_cow_wave():
    p = _prompts(1, lens=(8, 9))[0]
    wave = [p, p, p[:4], p, p]
    ref = _engine(page_size=4, prefix_cache=True).serve(PARAMS, wave)
    eng = _engine(page_size=4, prefix_cache=True, speculative=True)
    assert eng.serve(PARAMS, wave) == ref
    assert eng.cache.stats["cow_copies"] > 0


def test_spec_mid_decode_admission_byte_identical():
    prompts = _prompts(5)
    ref = _engine().serve(PARAMS, prompts)
    eng = _engine(speculative=True)
    rids = [eng.submit(p) for p in prompts[:2]]
    results, i, steps = {}, 2, 0
    while len(results) < len(prompts):
        if i < len(prompts) and steps % 2 == 0:
            rids.append(eng.submit(prompts[i]))
            i += 1
        eng.step(PARAMS)
        results.update(eng.collect())
        steps += 1
        assert steps < 500
    assert [results[r] for r in rids] == ref


def test_spec_eos_retires_identically():
    prompts = _prompts(4, seed=7)
    ref_eng = _engine()
    ref_eng.config.eos_token_id = 5
    eng = _engine(speculative=True)
    eng.config.eos_token_id = 5
    assert eng.serve(PARAMS, prompts) == ref_eng.serve(PARAMS, prompts)


# ---------------------------------------------------------------------------
# paged growth and rollback
# ---------------------------------------------------------------------------

class _WrongDrafter(Drafter):
    """Drafts the WRONG continuation (true greedy token + 1 mod vocab):
    every draft token is rejected."""

    def __init__(self, refs):
        self.refs = refs    # (prompt len, {"prompt", "out"})

    def draft(self, history, k):
        for plen, ref in self.refs:
            if history[:plen] == list(map(int, ref["prompt"])):
                done = len(history) - plen
                cont = ref["out"][done:done + k]
                wrong = [(int(t) + 1) % CFG.vocab_size for t in cont]
                return wrong + [1] * (k - len(wrong))
        raise AssertionError("unknown history")


def _single(max_new, **kw):
    p = np.asarray([3, 9, 4, 11], np.int32)
    ref = _engine(max_new=max_new, num_slots=1, page_size=4,
                  max_seq_len=16).serve(PARAMS, [p])
    refs = [(4, {"prompt": p, "out": ref[0]})]
    eng = _engine(max_new=max_new, num_slots=1, page_size=4, max_seq_len=16,
                  speculative=True, spec_k=4, drafter=_WrongDrafter(refs),
                  **kw)
    return p, ref, eng


def test_rejection_rolls_back_and_drafts_never_overdraft():
    """Full rejection every round: output byte-identical, drafts clamped
    to the remaining budget (rem 3/2/1 draft 2/1/0), two rollbacks that
    free nothing (the spans fit the admission reservation), the pool
    drained after retire."""
    p, ref, eng = _single(4)
    assert eng.serve(PARAMS, [p]) == ref
    st = eng.spec.stats
    assert st["accepted"] == 0 and st["rejected"] == st["drafted"] == 3
    assert st["rollbacks"] == 2 and st["rollback_pages"] == 0
    assert eng.mgr.num_free_pages == eng.mgr.usable_pages
    eng.mgr.check_conservation()


def test_truncate_frees_stranded_pages_engine_safety_net():
    """A page grown past the reservation is freed by the next rejection,
    never below the reservation, with the books balanced."""
    p, ref, eng = _single(8)
    rid = eng.submit(p)
    eng.step(PARAMS)                  # prefill + first sample
    eng.step(PARAMS)                  # one rejected speculative round
    eng.mgr.grow_to(rid, 16)          # strand a page (reservation: 3)
    assert len(eng.mgr.sequence_pages(rid)) == 4
    eng.mgr.check_conservation()
    eng.step(PARAMS)
    assert len(eng.mgr.sequence_pages(rid)) == 3
    assert eng.spec.stats["rollback_pages"] == 1
    results, steps = {}, 0
    while not results:
        eng.step(PARAMS)
        results.update(eng.collect())
        steps += 1
        assert steps < 100
    assert results[rid] == ref[0]
    assert eng.mgr.num_free_pages == eng.mgr.usable_pages


def test_pool_pressure_clamps_draft_instead_of_failing():
    p = np.asarray([3, 9, 4, 11], np.int32)
    ref = _engine(max_new=4, num_slots=1, page_size=4,
                  max_seq_len=16).serve(PARAMS, [p])
    eng = _engine(max_new=4, num_slots=1, page_size=4, max_seq_len=16,
                  num_pages=3, speculative=True, spec_k=4)
    assert eng.serve(PARAMS, [p]) == ref
    eng.mgr.check_conservation()


def test_cancel_mid_flight_stays_conserved():
    prompts = _prompts(4)
    eng = _engine(speculative=True, prefix_cache=True)
    rids = [eng.submit(p) for p in prompts]
    eng.step(PARAMS)
    eng.step(PARAMS)
    assert eng.cancel(rids[0])
    eng.step(PARAMS)                 # conservation audited in-step
    while eng.step(PARAMS) or eng._queue:
        pass
    done = eng.collect()
    assert rids[0] not in done and set(rids[1:]) <= set(done)


@pytest.mark.parametrize("refcounted", [False, True])
def test_grow_and_truncate_conserve_pages(refcounted):
    """Growth takes fresh pages at refcount 1 without committing them;
    truncation frees only exclusively held, uncached pages: a page shared
    with another sequence or held by the radix tree stays."""
    cls = RefcountedKVCacheManager if refcounted else PagedKVCacheManager
    mgr = cls(1, 12, 4, 1, 8, dtype=torch.float32, device="cpu")
    a = list(mgr.allocate("a", 6))                   # 2 pages
    assert mgr.grow_to("a", 6) == []
    added = mgr.grow_to("a", 13)                     # 4 pages
    assert len(added) == 2 and mgr._lens["a"] == 6
    mgr.check_conservation()
    with pytest.raises(MemoryError):
        mgr.grow_to("a", 4 * 40)
    assert mgr.sequence_pages("a") == a + added      # untouched
    freed = mgr.truncate_pages("a", 3)
    assert freed == added[1:] and len(mgr.sequence_pages("a")) == 3
    mgr.check_conservation()
    if refcounted:
        # share "a"'s last page with "b", cache "a"'s second page
        shared = mgr.sequence_pages("a")
        mgr.allocate("b", 12, shared=shared)
        mgr.adopt_cached(shared[1])
        assert mgr.truncate_pages("a", 1) == []      # shared: kept
        mgr.check_conservation()
        free0 = mgr.num_free_pages
        mgr.free("b")              # shared[2] frees, shared[1] stays cached
        assert mgr.num_free_pages == free0 + 1
        assert mgr.num_cached_pages == 1
        # a cached page a truncation releases stays resident
        grown = mgr.grow_to("a", 8)
        mgr.adopt_cached(grown[0])
        assert mgr.truncate_pages("a", 1) == []
        assert mgr.num_cached_pages == 2
        mgr.check_conservation()
    mgr.free("a")
    mgr.check_conservation()


# ---------------------------------------------------------------------------
# one program, the JAX keys; sampling and grammars on the spec step
# ---------------------------------------------------------------------------

def test_spec_storm_builds_one_program():
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, CFG.vocab_size,
                           (int(rng.randint(4, 48)),)).astype(np.int32)
               for _ in range(12)]
    eng = TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(max_new_tokens=8), num_slots=4,
        page_size=16, max_seq_len=64, chunk=2, device="cpu",
        speculative=True)
    rids = [eng.submit(p) for p in prompts[:4]]
    prog, i, steps, results = None, 4, 0, {}
    while len(results) < len(prompts):
        if i < len(prompts) and steps % 2 == 0:
            rids.append(eng.submit(prompts[i]))
            i += 1
        eng.step(PARAMS)
        prog = prog or eng._spec_step
        assert eng._spec_step is prog
        results.update(eng.collect())
        steps += 1
        assert steps < 2000
    # the key ends with the prefill flags (A8W8 on, the fixed routes)
    assert eng.compile_misses == [("cbe.spec_step", (
        4, eng._spec_tokens, 4, eng._table_width, False, 1, False, True,
        True, True))]
    assert eng.spec_rounds == steps


def test_speculative_requires_unified():
    with pytest.raises(ValueError, match="unified"):
        _engine(speculative=True, unified=False)


def _abc():
    from paddle_tpu.inference.constrain import compile_regex as jcompile
    from paddle_tpu_torch.inference.constrain import compile_regex
    vocab = ["<eos>"] + list("abcde") + [f"tok{i}" for i in range(6, 256)]
    return (jcompile("(ab|cd)*e", vocab, eos_token_id=0),
            compile_regex("(ab|cd)*e", vocab, eos_token_id=0))


def test_sampled_and_constrained_spec_serve_equals_jax_engine():
    """Rejection sampling, constrained rows (which never draft) and
    greedy rows on one speculative engine: the JAX engine's streams, a
    low temperature so drafts land."""
    jg, tg = _abc()
    prompts = _prompts(6, seed=2)
    kinds = [dict(), dict(temperature=0.05, seed=3),
             dict(temperature=1.1, top_k=8, seed=4), "grammar"]

    def subs(sampler_cls, gram):
        out = []
        for i in range(len(prompts)):
            k = kinds[i % len(kinds)]
            if k == "grammar":
                out.append(dict(grammar=gram,
                                sampler=sampler_cls(temperature=0.9,
                                                    seed=8)))
            else:
                out.append(dict(sampler=sampler_cls(**k)) if k else {})
        return out

    def serve(eng, params, s):
        rids = [eng.submit(p, **x) for p, x in zip(prompts, s)]
        out, steps = {}, 0
        while len(out) < len(rids):
            eng.step(params)
            out.update(eng.collect())
            steps += 1
            assert steps < 500
        return [list(out[r]) for r in rids]

    geo = dict(max_new=10, num_slots=3, speculative=True, spec_k=3,
               grammar_states=tg.n_states)
    eng = _engine(**geo)
    got = serve(eng, PARAMS, subs(SamplerConfig, tg))
    want = serve(_jengine(**geo), JPARAMS, subs(JSampler, jg))
    assert got == want
    assert eng.spec.stats["drafted"] > 0
    # greedy rows stay the non-speculative engine's
    plain = _engine(max_new=10, num_slots=3, grammar_states=tg.n_states)
    base = serve(plain, PARAMS, subs(SamplerConfig, tg))
    assert [got[i] for i in range(len(prompts)) if not kinds[i % 4]] == \
        [base[i] for i in range(len(prompts)) if not kinds[i % 4]]


def test_spec_do_sample_equals_jax_engine():
    gen = dict(max_new_tokens=6, do_sample=True, temperature=0.7, seed=3)
    prompts = _prompts(3)
    geo = dict(num_slots=2, page_size=16, max_seq_len=64, chunk=2,
               speculative=True)
    got = TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(**gen), device="cpu", **geo).serve(
            PARAMS, prompts)
    want = JEngine(JCFG, JGen(**gen), **geo).serve(JPARAMS, prompts)
    assert got == [list(o) for o in want]
    assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("step_tokens,warns", [(None, True), (16, True),
                                               (40, False), (64, False)])
def test_engine_warns_when_the_spec_axis_differs(step_tokens, warns):
    """8 slots, k 4: the speculative step packs 40 tokens. With a
    shorter plain axis (the default 16) the engine warns that its greedy
    streams are not bound to equal a plain engine's; with ``step_tokens``
    >= 40 both steps share the axis and it does not."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = _engine(num_slots=8, speculative=True, spec_k=4,
                      step_tokens=step_tokens)
    hits = [w for w in caught if "bit for bit" in str(w.message)]
    assert len(hits) == int(warns)
    assert eng._spec_tokens == max(40, step_tokens or 0)
