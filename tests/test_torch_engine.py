"""The serving engine: the PyTorch port's ``ContinuousBatchingEngine``
(unified greedy path) against the JAX package's unified engine, with the
JAX package's weights carried across through numpy. Greedy tokens must
be identical, request for request; the port runs on the CPU."""

import numpy as np
import pytest
import torch

from paddle_tpu.inference.decoding import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import rope as trope


def _engines(max_new=6, num_slots=2, chunk=3, seed=3, eos=None, **kw):
    """The JAX unified engine and the port's engine on the same
    llama_tiny(2 layers) weights (JAX-made, seed 3)."""
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    jparams = JL.init_stacked_params(jcfg, seed=seed)
    geo = dict(num_slots=num_slots, page_size=4, max_seq_len=64,
               chunk=chunk, **kw)
    jeng = JEngine(jcfg, JGen(max_new_tokens=max_new, eos_token_id=eos),
                   **geo)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    params = TL.params_from_numpy({k: np.asarray(v)
                                   for k, v in jparams.items()}, cfg, "cpu")
    teng = TD.ContinuousBatchingEngine(
        cfg, TD.GenerationConfig(max_new_tokens=max_new, eos_token_id=eos),
        device="cpu", **geo)
    return (jeng, jparams), (teng, params)


def _ragged_prompts(n, lens, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (int(lens[i % len(lens)]),))
            .astype(np.int32) for i in range(n)]


STORM_LENS = (5, 12, 3, 9, 17, 2, 7, 30)


def test_storm_tokens_identical_to_jax_unified_engine():
    """test_unified_step's storm (prefix cache off): ragged lengths and
    slot reuse through 2 slots, 3 micro-rounds per step."""
    (jeng, jp), (teng, tp) = _engines()
    prompts = _ragged_prompts(8, STORM_LENS, seed=1)
    want = jeng.serve(jp, prompts)
    got = teng.serve(tp, prompts)
    assert got == want
    for rid in range(len(prompts)):
        assert teng.finished_checksum(rid) == jeng.finished_checksum(rid)
    teng.mgr.check_conservation()
    assert teng.mgr.num_free_pages == teng.mgr.usable_pages


@pytest.mark.parametrize("num_slots,chunk,step_tokens", [(3, 2, None),
                                                         (2, 4, 6)])
def test_other_geometries_identical_to_jax(num_slots, chunk, step_tokens):
    """More slots, longer chunks and a tight packed budget (prefill rows
    starved behind decode rows)."""
    (jeng, jp), (teng, tp) = _engines(max_new=5, num_slots=num_slots,
                                      chunk=chunk, step_tokens=step_tokens)
    prompts = _ragged_prompts(6, (11, 4, 19, 1, 8, 25), seed=4)
    assert teng.serve(tp, prompts) == jeng.serve(jp, prompts)


def test_mid_decode_admission_identical_and_conserved():
    """A request admitted while others are mid-decode joins the running
    step; both engines are driven in lockstep, with the page books
    audited after every step, and the late request's tokens equal a
    fresh engine's."""
    (jeng, jp), (teng, tp) = _engines()
    early = _ragged_prompts(2, (11, 4), seed=5)
    late = _ragged_prompts(1, (7,), seed=9)[0]
    for eng in (jeng, teng):
        for p in early:
            eng.submit(p)
    for _ in range(2):                      # early requests now mid-decode
        jeng.step(jp)
        teng.step(tp)
        teng.mgr.check_conservation()
    assert any(len(teng._live[r].tokens) > 0 for r in teng._live)
    assert jeng.submit(late) == teng.submit(late) == 2
    got, want = {}, {}
    for _ in range(60):
        jeng.step(jp)
        teng.step(tp)
        teng.mgr.check_conservation()
        want.update(jeng.collect())
        got.update(teng.collect())
        if len(got) == 3 and len(want) == 3:
            break
    assert got == want and set(got) == {0, 1, 2}
    (_, _), (fresh, _) = _engines()
    assert fresh.serve(tp, [late]) == [got[2]]


def test_eos_stops_like_jax():
    (jeng, jp), _ = _engines(max_new=8)
    prompts = _ragged_prompts(4, (6, 13, 3, 9), seed=2)
    free_run = jeng.serve(jp, prompts)
    eos = free_run[1][2]                    # a token the model emits
    (jeng, jp), (teng, tp) = _engines(max_new=8, eos=eos)
    want = jeng.serve(jp, prompts)
    assert any(len(w) < 8 for w in want)
    assert teng.serve(tp, prompts) == want


def test_cancel_queued_and_live():
    _, (teng, tp) = _engines(max_new=6)
    prompts = _ragged_prompts(3, (5, 9, 4), seed=6)
    rids = [teng.submit(p) for p in prompts]
    assert teng.cancel(rids[2])             # queued: dropped
    teng.step(tp)
    assert teng.cancel(rids[1])             # live: retired, pages freed
    teng.mgr.check_conservation()
    while teng.step(tp):
        teng.mgr.check_conservation()
    out = teng.collect()
    assert set(out) == {rids[0]} and len(out[rids[0]]) == 6
    assert teng.finished_checksum(rids[1]) is None
    assert not teng.cancel(rids[1])
    assert teng.mgr.num_free_pages == teng.mgr.usable_pages


def test_submit_and_admission_limits():
    _, (teng, tp) = _engines(max_new=6)
    with pytest.raises(ValueError, match="max_seq_len"):
        teng.submit(np.ones(60, np.int32))
    cfg = TL.llama_tiny(num_hidden_layers=2)
    small = TD.ContinuousBatchingEngine(
        cfg, TD.GenerationConfig(max_new_tokens=6), num_slots=2,
        page_size=4, max_seq_len=64, num_pages=4, chunk=3, device="cpu")
    small.submit(np.ones(20, np.int32))     # 7 pages > 3 usable
    with pytest.raises(MemoryError, match="enlarge num_pages"):
        small.step(tp)
    assert len(small._queue) == 1           # requeued, nothing leaked
    small.mgr.check_conservation()


# ---------------------------------------------------------------------------
# options of the JAX engine that later slices port: refused, not emulated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(prefix_cache=True), dict(speculative=True), dict(unified=False),
    dict(fused_tail=True), dict(mesh=object()),
    dict(generation_config=TD.GenerationConfig(do_sample=True))],
    ids=["prefix_cache", "speculative", "legacy", "fused_tail", "mesh",
         "do_sample"])
def test_unported_engine_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="slice"):
        TD.ContinuousBatchingEngine(TL.llama_tiny(), device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(sampler=object()),
                                    dict(grammar=object()),
                                    dict(grammar_prefix=[1])],
                         ids=["sampler", "grammar", "grammar_prefix"])
def test_unported_submit_options_raise(kwargs):
    eng = TD.ContinuousBatchingEngine(TL.llama_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="sampling slice"):
        eng.submit(np.ones(4, np.int32), **kwargs)
    assert not eng._queue


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------

def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["engine", "manager", "init_params",
                                   "params_from_numpy", "rope"])
def test_entry_points_without_device_raise_when_no_gpu(monkeypatch, entry):
    _no_gpu(monkeypatch)
    cfg = TL.llama_tiny(num_hidden_layers=1)
    calls = {
        "engine": lambda: TD.ContinuousBatchingEngine(cfg),
        "manager": lambda: tpa.PagedKVCacheManager(1, 4, 4, 1, 8),
        "init_params": lambda: TL.init_params(cfg),
        "params_from_numpy": lambda: TL.params_from_numpy(
            {"ln_f": np.ones(64, np.float32)}, cfg),
        "rope": lambda: trope.build_rope_cache(8, 16),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_explicit_cuda_without_gpu_raises(monkeypatch):
    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TD.ContinuousBatchingEngine(TL.llama_tiny(), device="cuda")


def test_engine_state_lives_on_the_requested_device():
    _, (teng, _) = _engines()
    assert teng.device == torch.device("cpu")
    assert teng.mgr.k_pages.device.type == "cpu"
    assert teng._tok_dev.device.type == "cpu"
