"""Continuations of a stream that moved (a failover, a prefill -> decode
handoff): the port's ``submit(decoded=n)`` through the router, the
replica, the scheduler and ``ContinuousBatchingEngine``.

The continuation resubmits the streamed tokens as prompt tokens. The
uninterrupted run decoded each of them alone, as a carry token flagged
``decoding`` (the ragged attention kernels' key-split route); the
engine's plans must flag the same tokens when it prefills them, and
nothing else, so that on the card their K/V and logits are the
uninterrupted run's bits. Here, on the CPU, the plans are checked array
by array (the plain attention takes no route) and the streams against a
single engine's.

The legacy pipeline (``unified=False``) prefills only the given prompt
and forces the streamed tokens through its decode chunk, one a step:
its programs then get the uninterrupted run's inputs, byte for byte,
but for the decode chunk's ``forced`` tokens."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import decoding as D
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.resilience import Fault, FaultInjector
from paddle_tpu_torch.serving import (DisaggRouter, FleetRouter,
                                      HealthConfig, ReplicaHandle,
                                      ReplicaRole)
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

CFG = L.llama_tiny(num_hidden_layers=1)
LP, DECODED = 19, 7          # slot 1's prompt; its last 7 were decoded


@pytest.fixture(scope="module")
def params():
    return L.init_params(CFG, seed=4, device="cpu")


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, CFG.vocab_size, (n,)).astype(np.int32)
            for n in (5, LP)]


def _engine(speculative=False, **kw):
    return D.ContinuousBatchingEngine(
        CFG, D.GenerationConfig(max_new_tokens=6), num_slots=2,
        page_size=4, max_seq_len=64, chunk=3, step_tokens=8,
        speculative=speculative, spec_k=2, device="cpu", **kw)


def _serve_recorded(params, decoded, speculative):
    """Serve the two prompts (slot 1's with ``decoded``) and record a
    copy of every plan the engine wrote."""
    eng = _engine(speculative)
    name = "_plan_spec" if speculative else "_plan_step"
    real, plans = getattr(eng, name), []

    def record(plan):
        out = real(plan)
        plans.append({k: v.copy() for k, v in plan.items()})
        return out

    setattr(eng, name, record)
    p0, p1 = _prompts()
    rids = [eng.submit(p0), eng.submit(p1, decoded=decoded)]
    done = {}
    while len(done) < 2:
        eng.step(params)
        done.update(eng.collect())
    return plans, [done[r] for r in rids]


def _rounds(plans, speculative):
    """Every micro-round's flat arrays: (decoding, token_row, positions,
    carry) where ``carry`` marks the tokens a decoding row feeds."""
    for plan in plans:
        if speculative:
            # a span token sits at or past its row's prompt
            lp = np.asarray([5, LP])[np.clip(plan["token_row"], 0, 1)]
            yield (plan["decoding"], plan["token_row"], plan["positions"],
                   (plan["token_row"] >= 0) & (plan["positions"] >= lp))
        else:
            for k in range(plan["ids"].shape[0]):
                yield (plan["decoding"][k], plan["token_row"][k],
                       plan["positions"][k], plan["use_carry"][k])


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["unified", "speculative"])
def test_plan_flags_exactly_the_decoded_prompt_tokens(params, speculative):
    """The last ``decoded`` prompt tokens of slot 1 are flagged in every
    round that prefills them (the prefill is split over rounds and
    steps), every decoding row's tokens are flagged, and no other prompt
    token is."""
    plans, _ = _serve_recorded(params, DECODED, speculative)
    flagged, rounds_with = [], 0
    for dec, row, pos, carry in _rounds(plans, speculative):
        prompt = (row >= 0) & ~carry
        want = carry | (prompt & (row == 1) & (pos >= LP - DECODED))
        np.testing.assert_array_equal(dec, want)
        here = pos[prompt & dec]
        flagged += here.tolist()
        rounds_with += bool(here.size)
    assert sorted(flagged) == list(range(LP - DECODED, LP))
    if not speculative:
        assert rounds_with >= 2      # the decoded tokens span two rounds


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["unified", "speculative"])
def test_decoded_zero_leaves_every_plan_array_as_it_was(params,
                                                        speculative):
    """``decoded=0`` flags only the decoding rows' tokens (in the unified
    step exactly ``use_carry``, the flags the step passed before); the
    count changes no other plan array, and no token (the CPU's plain
    attention takes no route)."""
    plain, toks0 = _serve_recorded(params, 0, speculative)
    moved, toks = _serve_recorded(params, DECODED, speculative)
    assert toks == toks0
    assert len(plain) == len(moved)
    for a, b in zip(plain, moved):
        assert set(a) == set(b)
        for name in a:
            if name != "decoding":
                assert a[name].tobytes() == b[name].tobytes(), name
        if not speculative:
            np.testing.assert_array_equal(a["decoding"], a["use_carry"])
    for dec, row, pos, carry in _rounds(plain, speculative):
        np.testing.assert_array_equal(dec, carry)


def _legacy_recorded(params, decoded):
    """Legacy serve of the two prompts; slot 1's continues its
    uninterrupted stream after ``decoded`` of its tokens when given
    ``(stream, n)``. Returns every program call's (name, inputs) and the
    streams."""
    eng = _engine(unified=False)
    real, calls = eng._run, []

    def run(name, prog):
        calls.append((name, {k: v.copy() for k, v in prog.host.items()}))
        return real(name, prog)

    eng._run = run
    p0, p1 = _prompts()
    if decoded is None:
        rids = [eng.submit(p0), eng.submit(p1)]
    else:
        stream, n = decoded
        rids = [eng.submit(p0),
                eng.submit(np.concatenate([p1, np.asarray(stream[:n],
                                                           np.int32)]),
                           max_new_tokens=6 - n, decoded=n)]
    done = {}
    while len(done) < 2:
        eng.step(params)
        done.update(eng.collect())
    return calls, [done[r] for r in rids]


def test_legacy_decoded_zero_forces_nothing(params):
    """A fresh prompt: every decode chunk's ``forced`` input is -1 (each
    step keeps its own token) beside the inputs it had before."""
    calls, _ = _legacy_recorded(params, None)
    chunks = [h for name, h in calls if name == "cbe.decode_chunk"]
    assert chunks and all(set(h) == {"pos", "bt", "forced"} for h in chunks)
    assert all((h["forced"] == -1).all() for h in chunks)


@pytest.mark.parametrize("n", [1, 4])
def test_legacy_continuation_forces_the_streamed_tokens(params, n):
    """Slot 1 resubmitted as prompt + its first ``n`` streamed tokens
    (``decoded=n``): the prefill runs the given prompt only, the decode
    chunks force the streamed tokens in order from the first step (over
    two chunks at n 4, chunk 3), nothing is delivered twice, the rest of
    the stream equals the uninterrupted one, and every program input but
    ``forced`` is the uninterrupted run's, byte for byte."""
    plain, streams = _legacy_recorded(params, None)
    moved, got = _legacy_recorded(params, (streams[1], n))
    assert got == [streams[0], streams[1][n:]]
    assert [name for name, _ in moved] == [name for name, _ in plain]
    forced, lens = [], []
    for (name, a), (_, b) in zip(plain, moved):
        assert set(a) == set(b)
        for k in a:
            if k != "forced":
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
        if name == "cbe.prefill":
            lens += b["lens"].tolist()
        if name == "cbe.decode_chunk":
            row = b["forced"][1]
            live = row[row >= 0]
            assert (row[:len(live)] == live).all() and (b["forced"][0]
                                                        == -1).all()
            forced += live.tolist()
    assert forced == streams[1][:n]
    assert sorted(lens) == [5, LP]          # the given prompts, whole


def test_legacy_continuation_prefills_a_partly_cached_prompt_whole(params):
    """A legacy continuation whose given prompt the prefix cache covers
    only in part (two pages of another request's prompt) is prefilled
    whole in a cold wave, as the uninterrupted run prefilled it (the
    suffix path would attend through a page gather); the shared pages'
    entries in its rows go to the reserved page 0, so the cached pages
    keep their bytes, and the stream continues the uninterrupted one."""
    _, p1 = _prompts()
    plain = _engine(unified=False, prefix_cache=True)
    stream = plain.serve(params, [p1])[0]
    eng = _engine(unified=False, prefix_cache=True)
    eng.serve(params, [p1[:10]])          # caches p1's first two pages
    shared, n_cached, _ = eng.cache.lookup(p1)
    assert n_cached == 8 and len(shared) == 2
    before = [eng.mgr.k_pages[:, q].clone() for q in shared]
    real, calls = eng._run, []

    def run(name, prog):
        calls.append((name, {k: v.copy() for k, v in prog.host.items()}))
        return real(name, prog)

    eng._run = run
    n = 4
    rid = eng.submit(np.concatenate([p1, np.asarray(stream[:n], np.int32)]),
                     max_new_tokens=6 - n, decoded=n)
    done = {}
    while rid not in done:
        eng.step(params)
        done.update(eng.collect())
    prefill = [h for name, h in calls if name == "cbe.prefill"]
    assert len(prefill) == 1 and "starts" not in prefill[0]
    assert prefill[0]["lens"][0] == LP
    assert (prefill[0]["rows"][0, :2] == 0).all()
    assert (prefill[0]["rows"][0, 2:5] > 0).all()
    assert all(torch.equal(b, eng.mgr.k_pages[:, q])
               for b, q in zip(before, shared))
    assert done[rid] == stream[n:]


def test_submit_rejects_a_count_beyond_the_prompt():
    eng = _engine()
    with pytest.raises(ValueError, match="decoded"):
        eng.submit(np.arange(1, 5, dtype=np.int32), decoded=5)
    with pytest.raises(ValueError, match="decoded"):
        eng.submit(np.arange(1, 5, dtype=np.int32), decoded=-1)


def _fleet_engine(**kw):
    return D.ContinuousBatchingEngine(
        CFG, D.GenerationConfig(max_new_tokens=8), num_slots=2,
        page_size=4, max_seq_len=64, chunk=2, device="cpu", **kw)


def _spy(handles):
    """Record every engine submission: (replica, prompt, decoded)."""
    seen = []
    for h in handles:
        real = h.engine.submit

        def submit(prompt, *a, _real=real, _rid=h.replica_id, **kw):
            seen.append((_rid, np.asarray(prompt).tolist(),
                         kw.get("decoded", 0)))
            return _real(prompt, *a, **kw)

        h.engine.submit = submit
    return seen


@pytest.mark.parametrize("mode", ["failover", "handoff"])
def test_continuation_passes_the_streamed_count_to_the_engine(params, mode):
    """A request that moves (replica 0 killed mid-decode, or handed from
    a PREFILL to a DECODE replica) reaches the destination's engine as
    prompt + streamed tokens with ``decoded`` = the streamed count; the
    streams equal a single engine's."""
    _check_moved_count(params, mode, unified=True)


@pytest.mark.parametrize("mode", ["failover", "handoff"])
def test_legacy_continuation_passes_the_streamed_count_to_the_engine(
        params, mode):
    """The same moves between legacy replicas (``unified=False``)."""
    _check_moved_count(params, mode, unified=False)


def _check_moved_count(params, mode, unified):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, CFG.vocab_size, (int(n),)).astype(np.int32)
               for n in (9, 14, 6, 11)]
    oracle = _fleet_engine(unified=unified).serve(params, prompts)
    inj = FaultInjector()
    handles = [ReplicaHandle(i, _fleet_engine(prefix_cache=True,
                                              unified=unified),
                             health_config=HealthConfig(eject_after=1))
               for i in range(2)]
    seen = _spy(handles)
    if mode == "handoff":
        router = DisaggRouter(handles, roles={0: ReplicaRole.PREFILL,
                                              1: ReplicaRole.DECODE})
    else:
        router = FleetRouter(handles, fault_injector=inj)
    reqs = [router.submit(p) for p in prompts]
    armed = False
    while router.pending:
        if mode == "failover" and not armed and any(
                r.replica_id == 0 and 0 < len(r.stream.tokens) < 8
                for r in reqs):
            armed = True
            inj.schedule.append(Fault("replica_die", router._steps + 1,
                                      replica=0))
        router.step(params)
    assert [r.stream.tokens for r in reqs] == oracle
    moved = [(rid, p, n) for rid, p, n in seen if n > 0]
    assert moved, "no stream moved"
    for rid, prompt, n in moved:
        assert rid == 1
        req = next(r for r in reqs
                   if prompt[:len(r.prompt)] == r.prompt.tolist())
        assert len(prompt) == len(req.prompt) + n
        assert prompt[len(req.prompt):] == req.stream.tokens[:n]
    # fresh prompts carry no count
    assert all(n == 0 for _, p, n in seen
               if any(p == q.tolist() for q in prompts))
