"""The sampling slice of the PyTorch port against the JAX package on the
CPU: ``inference.prng`` against ``jax.random`` (threefry keys, fold_in,
split, bits and uniforms bit for bit; gumbel within 2 ulp of ``log``),
the sampling epilogue (``inference.sampling``) and the grammar compiler
and arena (``inference.constrain``) against the JAX package's on the same
numpy inputs, and the serving engines' sampled, constrained and mixed
serves against the JAX engines' token streams, with JAX-made weights.

Near-ties: XLA's ``log``, ``exp`` and sums can differ from PyTorch's by
an ulp, so a draw whose winning margin (best minus second best of
gumbel + logits, in the reference) is under 4 ulp may go either way.
Unit tests count such rows and excuse only them; engine tests expect
none at these sizes and hold the streams identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import constrain as JC
from paddle_tpu.inference import sampling as JS
from paddle_tpu.inference.decoding import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import constrain as TC
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference import prng
from paddle_tpu_torch.inference import sampling as TS
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

NEAR_TIE_ULPS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jkey_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# ---------------------------------------------------------------------------
# prng against jax.random
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 7, 42, 12345, 2**31 - 1, 2**32 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_are_jax_bits(seed):
    jk = jax.random.PRNGKey(np.uint32(seed))
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  np.asarray(jk).astype(np.int64))
    for d in (0, 1, 2, 9, 1000, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(seed), d).numpy(),
            np.asarray(jax.random.fold_in(jk, d)).astype(np.int64))
    s31 = seed & 0x7FFFFFFF
    np.testing.assert_array_equal(
        prng.split(prng.prng_key(s31), 5).numpy(),
        _jkey_data(jax.random.split(jax.random.key(s31), 5)))


def test_batched_keys_are_vmapped_jax_keys():
    """The epilogue's key for (seed, position, salt) over a batch:
    ``fold_in(fold_in(PRNGKey(seed), pos), salt)`` under ``jax.vmap``."""
    rng = np.random.RandomState(0)
    seeds = rng.randint(0, 2**32, 300, dtype=np.int64).astype(np.uint32)
    pos = rng.randint(0, 1 << 20, 300).astype(np.int32)
    for salt in (TS.SALT_DRAW, TS.SALT_ACCEPT, TS.SALT_RESAMPLE):
        want = np.asarray(JS._keys(jnp.asarray(seeds), jnp.asarray(pos),
                                   salt)).astype(np.int64)
        got = TS._keys(_t(seeds.astype(np.int64)), _t(pos), salt).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_are_jax_bits(seed):
    jk = jax.random.PRNGKey(np.uint32(seed))
    tk = prng.prng_key(seed)
    for shape in ((1,), (257,), (3, 70)):
        np.testing.assert_array_equal(
            prng.bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    np.testing.assert_array_equal(
        prng.uniform(tk, (4096,)).numpy(),
        np.asarray(jax.random.uniform(jk, (4096,))))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(tk, (4096,), minval=tiny).numpy(),
        np.asarray(jax.random.uniform(jk, (4096,), minval=tiny)))
    # scalar uniforms under a batch of keys (the accept coin)
    keys = jax.random.split(jk, 64)
    np.testing.assert_array_equal(
        prng.uniform(_t(np.asarray(keys).astype(np.int64))).numpy(),
        np.asarray(jax.vmap(jax.random.uniform)(keys)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp_of_jax(seed):
    """``-log(-log(u))`` over the same uniforms: XLA's ``log`` and
    PyTorch's differ by an ulp, which the outer ``log`` carries as an
    absolute error of about an ulp at 1."""
    jg = np.asarray(jax.random.gumbel(jax.random.PRNGKey(np.uint32(seed)),
                                      (50000,)))
    tg = prng.gumbel(prng.prng_key(seed), (50000,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert np.all(np.abs(tg - jg) <= 2 * ulp)


def _margins(g, logits):
    """The winning margin of argmax(g + logits) per row, and its ulp."""
    z = np.sort(g + logits, axis=-1)
    top, second = z[..., -1], z[..., -2]
    return top - second, np.spacing(np.abs(top).astype(np.float32))


def test_categorical_equals_jax_up_to_counted_near_ties():
    rng = np.random.RandomState(3)
    R, V = 256, 512
    logits = (rng.randn(R, V) * 2).astype(np.float32)
    seeds = rng.randint(0, 2**31, R).astype(np.uint32)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jkeys, jnp.asarray(logits)))
    got = prng.categorical(prng.prng_key(_t(seeds.astype(np.int64))),
                           _t(logits)).numpy()
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jkeys))
    margin, ulp = _margins(g, logits)
    near = margin < NEAR_TIE_ULPS * ulp
    assert np.all((got == want) | near)
    assert near.sum() == 0           # none expected at this size
    # one key over a whole (B, V) batch: the counters run over every
    # element (the legacy programs' draw)
    one = jax.random.PRNGKey(5)
    want1 = np.asarray(jax.random.categorical(one, jnp.asarray(logits)))
    got1 = prng.categorical(prng.prng_key(5), _t(logits)).numpy()
    np.testing.assert_array_equal(got1, want1)


# ---------------------------------------------------------------------------
# SamplerConfig, row state, process_logits
# ---------------------------------------------------------------------------

def test_sampler_config_resolved_and_row_state():
    c = TS.SamplerConfig(temperature=0.7, top_k=5, top_p=0.9)
    assert c.seed is None
    r = c.resolved(1234)
    assert r.seed == 1234 and r.temperature == 0.7
    assert TS.SamplerConfig(seed=9).resolved(1234).seed == 9
    samp = TS.init_row_state(3, device="cpu")
    TS.set_row(samp, 1, TS.SamplerConfig(temperature=0.5, top_k=3,
                                         top_p=0.8, seed=2**32 - 1))
    assert int(samp[0][1]) == 2**32 - 1 and int(samp[2][1]) == 3
    TS.set_row(samp, 1, None)                     # slot reuse resets
    assert float(samp[1][1]) == 0.0 and float(samp[3][1]) == 1.0


def _proc_case(temp, top_k, top_p, R=6, V=32, seed=0):
    rng = np.random.RandomState(seed)
    lg = rng.randn(R, V).astype(np.float32)
    lg[2, :V // 2] = lg[2, V // 2:]               # planted ties
    return (lg, np.full((R,), temp, np.float32),
            np.full((R,), top_k, np.int32), np.full((R,), top_p, np.float32))


def _cum_near_ties(x, top_p):
    """Rows whose top-p cutoff could flip: a cumulative probability
    within NEAR_TIE_ULPS ulp of ``top_p``."""
    srt = -np.sort(-x, axis=-1)
    e = np.exp(srt - srt[:, :1])
    cum = np.cumsum(e / e.sum(-1, keepdims=True), axis=-1)
    tol = NEAR_TIE_ULPS * np.spacing(np.float32(1.0))
    near = (np.abs(cum - top_p[:, None]) < tol).any(axis=-1)
    return near & (top_p < 1.0)


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 5, 1.0), (1.0, 0, 0.8),
    (0.9, 7, 0.6), (1.0, 1, 1.0), (0.8, 50, 0.95)])
def test_process_logits_matches_jax(temp, top_k, top_p):
    """Finite values bit-identical; the same ``-inf`` set except rows
    with a cumulative probability at the top-p cutoff (counted: none)."""
    lg, t, k, p = _proc_case(temp, top_k, top_p, R=16, V=64)
    want = np.asarray(JS.process_logits(*map(jnp.asarray, (lg, t, k, p))))
    got = TS.process_logits(*map(_t, (lg, t, k, p))).numpy()
    near = _cum_near_ties(np.where(np.isinf(want), -np.inf, lg / temp), p)
    same_set = (np.isinf(got) == np.isinf(want)).all(axis=-1)
    assert np.all(same_set | near) and near.sum() == 0
    fin = np.isfinite(want) & np.isfinite(got)
    np.testing.assert_array_equal(got[fin], want[fin])


# ---------------------------------------------------------------------------
# the epilogues on the same logits
# ---------------------------------------------------------------------------

def _row_state(R, seed):
    rng = np.random.RandomState(seed)
    seeds = rng.randint(0, 2**32, R, dtype=np.int64).astype(np.uint32)
    temps = rng.choice([0.0, 0.5, 1.0, 1.3], R).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 50], R).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5], R).astype(np.float32)
    j = tuple(jnp.asarray(a) for a in (seeds, temps, top_k, top_p))
    t = (_t(seeds.astype(np.int64)), _t(temps), _t(top_k), _t(top_p))
    return j, t


def _abc_vocab(V=256):
    return ["<eos>"] + list("abcde") + [f"tok{i}" for i in range(6, V)]


def _arenas(V, gram=None, cap=8):
    ja, ta = JC.GrammarArena(V, cap), TC.GrammarArena(V, cap)
    if gram is not None:
        ja.register(gram[0])
        ta.register(gram[1])
    return ja.device_table(), ta.table


@pytest.fixture(scope="module")
def abc():
    """The same grammar compiled by both packages."""
    return (JC.compile_regex("(ab|cd)*e", _abc_vocab(), eos_token_id=0),
            TC.compile_regex("(ab|cd)*e", _abc_vocab(), eos_token_id=0))


def test_sample_rows_matches_jax(abc):
    R, V = 64, 256
    rng = np.random.RandomState(1)
    lg = (rng.randn(R, V) * 3).astype(np.float32)
    pos = rng.randint(0, 1000, R).astype(np.int32)
    gst = rng.choice([-1, -1, 0, 1, 2], R).astype(np.int32)
    (js, ts), (jt, tt) = _row_state(R, 2), _arenas(V, abc)
    jl = JC.mask_logits(jnp.asarray(lg), jnp.asarray(gst), jt)
    tl = TC.mask_logits(_t(lg), _t(gst), tt)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    wt, wg = JS.sample_rows(jl, jnp.asarray(pos), js, jnp.asarray(gst), jt)
    gt, gg = TS.sample_rows(tl, _t(pos), ts, _t(gst), tt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    assert gt.dtype == torch.int32 and gg.dtype == torch.int32


@pytest.mark.parametrize("k", [0, 1, 3])
def test_spec_rows_match_jax(k, abc):
    """Greedy and sampled verifiers: identical tokens, accepted counts
    and grammar states (drafts half argmax, half random)."""
    R, V = 48, 256
    rng = np.random.RandomState(k)
    lg = (rng.randn(R, k + 1, V) * 2).astype(np.float32)
    drafts = rng.randint(0, V, (R, max(k, 1))).astype(np.int32)
    drafts[::2, :k] = lg[::2, :k].argmax(-1)
    dlen = rng.randint(0, k + 1, R).astype(np.int32)
    pos = rng.randint(0, 500, R).astype(np.int32)
    gst = rng.choice([-1, -1, 0, 1], R).astype(np.int32)
    dlen[gst >= 0] = 0                            # constrained: no draft
    (js, ts), (jt, tt) = _row_state(R, 3 + k), _arenas(V, abc)
    args_j = (jnp.asarray(lg), jnp.asarray(drafts), jnp.asarray(dlen),
              jnp.asarray(pos), js, jnp.asarray(gst), jt)
    args_t = (_t(lg), _t(drafts), _t(dlen), _t(pos), ts, _t(gst), tt)
    for jf, tf in ((JS.spec_sample_rows, TS.spec_sample_rows),
                   (JS.spec_greedy_rows, TS.spec_greedy_rows)):
        want = [np.asarray(a) for a in jf(*args_j)]
        got = [a.numpy() for a in tf(*args_t)]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_spec_greedy_rows_prefix_match():
    """temperature 0 rows accept the longest prefix where the draft
    equals the argmax, then the correction or the bonus token."""
    R, V, k = 2, 6, 2
    lg = np.full((R, k + 1, V), -5.0, np.float32)
    lg[:, 0, 3] = lg[:, 1, 1] = lg[:, 2, 4] = 5.0  # argmax path 3,1,4
    samp = TS.init_row_state(R, device="cpu")              # greedy defaults
    gst = torch.full((R,), -1, dtype=torch.int32)
    toks, acc, _ = TS.spec_sample_rows(
        _t(lg), _t(np.asarray([[3, 1], [3, 2]], np.int32)),
        torch.full((R,), k, dtype=torch.int32), torch.zeros(R, dtype=
                                                            torch.int32),
        samp, gst, TC.GrammarArena(V, 1).table)
    assert acc.tolist() == [2, 1]
    assert int(toks[0, 2]) == 4 and int(toks[1, 1]) == 1


def test_rejection_sampling_distribution_identity():
    """The reference's R=4000 property test on the port: the verifier's
    delivered token (accepted draft or residual resample) and the plain
    epilogue both match the target softmax within 0.03."""
    R, V, k = 4000, 8, 1
    row = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5, -2.0])
    target = torch.softmax(row, -1).numpy()
    samp = (torch.arange(R, dtype=torch.int64), torch.ones(R),
            torch.zeros(R, dtype=torch.int32), torch.ones(R))
    gst = torch.full((R,), -1, dtype=torch.int32)
    gtable = TC.GrammarArena(V, 1).table
    pos = torch.zeros(R, dtype=torch.int32)
    toks, acc, _ = TS.spec_sample_rows(
        row.expand(R, k + 1, V), torch.zeros((R, k), dtype=torch.int32),
        torch.ones(R, dtype=torch.int32), pos, samp, gst, gtable)
    acc = acc.numpy()
    assert set(np.unique(acc)) <= {0, 1}
    assert abs(acc.mean() - target[0]) < 0.03
    delivered = np.where(acc >= 1, 0, toks[:, 0].numpy())
    emp_spec = np.bincount(delivered, minlength=V) / R
    plain, _ = TS.sample_rows(row.expand(R, V), pos, samp, gst, gtable)
    emp_plain = np.bincount(plain.numpy(), minlength=V) / R
    assert np.abs(emp_spec - target).max() < 0.03
    assert np.abs(emp_plain - target).max() < 0.03


# ---------------------------------------------------------------------------
# grammar compiler and arena
# ---------------------------------------------------------------------------

def _json_vocab(V=256):
    toks = ["<eos>"] + list('{}[]:, ') + ['"', '\\']
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789+-.eE")
    while len(toks) < V:
        toks.append(f"<junk{len(toks)}>")
    return toks


@pytest.mark.parametrize("pattern", ["(ab|cd)*e", "[a-c]{2,3}d?e",
                                     "json1", "json2"])
def test_token_dfa_tables_equal_jax(pattern):
    if pattern.startswith("json"):
        depth = int(pattern[-1])
        want = JC.json_grammar(_json_vocab(), 0, max_depth=depth)
        got = TC.json_grammar(_json_vocab(), 0, max_depth=depth)
    else:
        want = JC.compile_regex(pattern, _abc_vocab(), 0)
        got = TC.compile_regex(pattern, _abc_vocab(), 0)
    assert np.array_equal(got.trans, want.trans)
    assert np.array_equal(got.accepting, want.accepting)
    assert (got.start, got.fingerprint) == (want.start, want.fingerprint)


def test_token_dfa_walk_eos_and_stuck_grammar(abc):
    g = abc[1]
    st = g.start
    for tok in (1, 2, 3, 4, 5):
        assert g.legal(st, tok)
        st = g.advance(st, tok)
    assert bool(g.accepting[st]) and g.legal(st, 0)
    assert not g.legal(g.start, 0) and g.advance(g.start, 2) == -1
    assert set(g.allowed_tokens(g.start)) == {1, 3, 5}
    with pytest.raises(ValueError, match="stuck"):
        TC.compile_regex("ab", ["<eos>", "a", "c"] + ["x"] * 29, 0)


def test_grammar_arena_dedupe_capacity_and_in_place_table(abc):
    g = abc[1]
    arena = TC.GrammarArena(256, capacity_states=g.n_states + 2)
    table = arena.table
    off = arena.register(g)
    assert arena.register(g) == off and arena.used == g.n_states
    other = TC.compile_regex("(ab)*e", _abc_vocab(), eos_token_id=0)
    with pytest.raises(ValueError, match="grammar_states"):
        arena.register(other)
    with pytest.raises(ValueError, match="vocab"):
        TC.GrammarArena(16).register(g)
    assert arena.table is table                   # written in place
    ja = JC.GrammarArena(256, capacity_states=g.n_states + 2)
    ja.register(abc[0])
    np.testing.assert_array_equal(table.numpy(), np.asarray(
        ja.device_table()))


def test_mask_logits_noop_for_unconstrained_rows(abc):
    arena = TC.GrammarArena(256, capacity_states=8)
    arena.register(abc[1])
    lg = torch.from_numpy(np.random.RandomState(0).randn(2, 256)
                          .astype(np.float32))
    out = TC.mask_logits(lg, torch.tensor([-1, 0], dtype=torch.int32),
                         arena.table)
    assert torch.equal(out[0], lg[0])
    legal = set(abc[1].allowed_tokens(0))
    assert all((t in legal) == bool(torch.isfinite(out[1, t]))
               for t in range(256))


# ---------------------------------------------------------------------------
# engines on a tiny Llama: the JAX engine's token streams
# ---------------------------------------------------------------------------

def _weights(seed=0):
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    jp = JL.init_stacked_params(jcfg, seed=seed)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              cfg, "cpu")
    return jcfg, jp, cfg, tp


W = _weights()


def _prompts(n=4, lens=(4, 12), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, (int(rng.randint(*lens)),)).astype(np.int32)
            for _ in range(n)]


def _pair(max_new=8, num_slots=2, chunk=2, gen=None, **kw):
    gen = dict(max_new_tokens=max_new, **(gen or {}))
    geo = dict(num_slots=num_slots, page_size=16, max_seq_len=64,
               chunk=chunk, **kw)
    return (JEngine(W[0], JGen(**gen), **geo),
            TD.ContinuousBatchingEngine(W[2], TD.GenerationConfig(**gen),
                                        device="cpu", **geo))


def _run(eng, params, prompts, subs, late=(), late_step=2):
    """Submit ``prompts`` with per-request submit kwargs ``subs`` (the
    ``late`` ones after ``late_step`` steps); serve to completion."""
    rids = [eng.submit(p, **s) for p, s in zip(prompts, subs)]
    out, steps = {}, 0
    while len(out) < len(prompts) + len(late):
        eng.step(params)
        out.update(eng.collect())
        steps += 1
        if steps == late_step:
            rids += [eng.submit(p, **s) for p, s in late]
        assert steps < 500
    return [out[r] for r in rids]


def _both(pair, prompts, subs_j, subs_t, **kw):
    jeng, teng = pair
    want = _run(jeng, W[1], prompts, subs_j, **kw)
    got = _run(teng, W[3], prompts, subs_t, **kw)
    return want, got


def _sub(**kw):
    """One request's submit kwargs for each package."""
    j, t = {}, {}
    if "sampler" in kw:
        j["sampler"] = JS.SamplerConfig(**kw["sampler"])
        t["sampler"] = TS.SamplerConfig(**kw["sampler"])
    if "grammar" in kw:
        j["grammar"], t["grammar"] = kw["grammar"]
    if "grammar_prefix" in kw:
        j["grammar_prefix"] = t["grammar_prefix"] = kw["grammar_prefix"]
    return j, t


@pytest.mark.parametrize("chunk", [2, 3])
def test_sampled_serve_equals_jax_engine(chunk):
    sc = dict(temperature=0.9, top_k=12, top_p=0.95, seed=77)
    prompts = _prompts(4)
    j, t = _sub(sampler=sc)
    want, got = _both(_pair(chunk=chunk), prompts, [j] * 4, [t] * 4)
    assert got == want
    assert got != _run(_pair(chunk=chunk)[1], W[3], prompts, [{}] * 4)


def test_seeded_replay_across_chunk_sizes():
    """The position is the PRNG counter: the same seeds give the same
    streams whatever the chunk, the slot count or the batch."""
    sc = dict(temperature=1.1, top_p=0.9, seed=5)
    prompts = _prompts(3, seed=4)
    subs = [{"sampler": TS.SamplerConfig(**sc)}] * 3
    runs = [_run(_pair(chunk=c, num_slots=n)[1], W[3], prompts, subs)
            for c, n in ((2, 2), (4, 2), (1, 3))]
    assert runs[0] == runs[1] == runs[2]


def test_constrained_and_mixed_serve_equals_jax_engine(abc):
    """Greedy, sampled, constrained (greedy and sampled) and a resumed
    constrained stream in one serve with mid-decode admissions: every
    stream the JAX engine's, every constrained token legal."""
    gram = abc
    prompts = _prompts(8, seed=5)
    kinds = [dict(), dict(sampler=dict(temperature=0.9, seed=31)),
             dict(grammar=gram),
             dict(sampler=dict(temperature=1.2, top_k=9, seed=32),
                  grammar=gram),
             dict(sampler=dict(temperature=0.8, seed=4), grammar=gram,
                  grammar_prefix=[1, 2, 3])]
    subs = [_sub(**kinds[i % len(kinds)]) for i in range(len(prompts))]
    pair = _pair(max_new=6, num_slots=4, grammar_states=gram[0].n_states)
    late = 5
    jeng, teng = pair
    want = _run(jeng, W[1], prompts[:late], [s[0] for s in subs[:late]],
                late=list(zip(prompts[late:], [s[0] for s in subs[late:]])))
    got = _run(teng, W[3], prompts[:late], [s[1] for s in subs[:late]],
               late=list(zip(prompts[late:], [s[1] for s in subs[late:]])))
    assert got == want
    for i, toks in enumerate(got):
        k = kinds[i % len(kinds)]
        if "grammar" in k:
            st = gram[1].start
            for tok in list(k.get("grammar_prefix", ())) + toks:
                assert gram[1].legal(st, tok)
                st = gram[1].advance(st, tok)
    c = teng.sampling_counts
    assert c["paddle_sampling_violations_total"] == 0
    assert c["paddle_sampling_requests_total"]["constrained"] == sum(
        "grammar" in kinds[i % len(kinds)] for i in range(len(prompts)))
    assert c["paddle_sampling_tokens_total"]["sampled"] > 0
    assert c["paddle_sampling_grammar_states"] == gram[1].n_states


def test_json_constrained_serve_equals_jax_engine():
    want_g = JC.compile_regex(JC.json_regex(max_depth=1), _json_vocab(), 0)
    got_g = TC.compile_regex(TC.json_regex(max_depth=1), _json_vocab(), 0)
    prompts = _prompts(4, seed=3)
    subs = [_sub(grammar=(want_g, got_g)),
            _sub(grammar=(want_g, got_g),
                 sampler=dict(temperature=1.5, top_p=0.9, seed=22))] * 2
    want, got = _both(_pair(max_new=12, num_slots=4,
                            grammar_states=want_g.n_states), prompts,
                      [s[0] for s in subs], [s[1] for s in subs])
    assert got == want and all(got)


@pytest.mark.parametrize("unified", [True, False])
def test_engine_wide_do_sample_equals_jax_engine(unified):
    """``GenerationConfig(do_sample=True)``: unified, a per-request
    sampler seeded from (config seed, rid); legacy, the engine's key
    chain split per prefill wave, per decode chunk and per step."""
    gen = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
               seed=3)
    prompts = _prompts(5, lens=(3, 20), seed=6)
    want, got = _both(_pair(max_new=7, gen=gen, unified=unified), prompts,
                      [{}] * 5, [{}] * 5)
    assert got == want


def test_legacy_do_sample_with_prefix_cache_equals_jax_engine():
    gen = dict(do_sample=True, temperature=1.0, seed=9)
    p = _prompts(3, lens=(18, 30), seed=8)
    prompts = [p[0], np.concatenate([p[0][:16], p[1]]), p[2], p[0].copy()]
    want, got = _both(_pair(max_new=5, gen=gen, unified=False,
                            prefix_cache=True), prompts, [{}] * 4, [{}] * 4)
    assert got == want


def test_lazy_epilogue_costs_exactly_one_counted_rebuild(monkeypatch):
    """A greedy serve builds the argmax-only step; the first sampled
    submit rebuilds it once with the epilogue (the JAX engine's miss
    record, keys included), and later mixes rebuild nothing."""
    from paddle_tpu.inference import decoding as JD
    recorded = []
    monkeypatch.setattr(JD.recompiles, "record_miss",
                        lambda name, key: recorded.append((name, key)))
    jeng, teng = _pair(max_new=4)
    prompts = _prompts(2)
    sc = dict(temperature=0.9, seed=1)
    for eng, params, cls in ((jeng, W[1], JS.SamplerConfig),
                             (teng, W[3], TS.SamplerConfig)):
        _run(eng, params, prompts, [{}] * 2)
        _run(eng, params, prompts, [{"sampler": cls(**sc)}, {}])
        _run(eng, params, prompts, [{}, {"sampler": cls(**sc)}])
    got = teng.compile_misses
    assert [n for n, _ in got] == ["cbe.unified_step"] * 2
    assert [k[6] for _, k in got] == [False, True]     # the epilogue
    assert all(tuple(wk[:len(gk)]) == gk
               for (_, gk), (_, wk) in zip(got, recorded))
    assert len(recorded) == 2
