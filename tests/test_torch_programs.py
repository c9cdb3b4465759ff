"""The serving engines' compiled programs (``inference/graphs.py``) on the
CPU: the port's engines build the JAX engines' programs (the same names
and keys, as ``recompiles.record_miss`` records them) for the same
storms, rebuild for new weights, and every kernel wrapper's launch
counter is in the registry that lets a CUDA graph count its replays. The
card's side (capture, replay, counts) is in tests/test_torch_gpu.py."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.inference import decoding as JD
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference.graphs import Program, params_key
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops import _common
from paddle_tpu_torch.ops import rms_norm as rn
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

STORM_LENS = (5, 12, 3, 9, 17, 2, 7, 30)
GEO = dict(num_slots=2, page_size=4, max_seq_len=64, chunk=3)


def _weights(seed):
    jcfg = JL.llama_tiny(num_hidden_layers=2)
    jparams = JL.init_stacked_params(jcfg, seed=seed)
    cfg = TL.llama_tiny(num_hidden_layers=2)
    params = TL.params_from_numpy({k: np.asarray(v)
                                   for k, v in jparams.items()}, cfg, "cpu")
    return jcfg, jparams, cfg, params


W = _weights(3)


def _prompts(n, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, (int(lens[i % len(lens)]),))
            .astype(np.int32) for i in range(n)]


def _storm(prefix_cache):
    """The storm of tests/test_torch_legacy_engine.py (with the cache:
    shared prefixes and an exact repeat, the COW wave)."""
    prompts = _prompts(8, STORM_LENS, seed=1)
    if prefix_cache:
        prompts[3] = np.concatenate([prompts[1], prompts[2]])
        prompts[5] = prompts[1].copy()
    return prompts


def _port_engine(max_new=6, **kw):
    return TD.ContinuousBatchingEngine(
        W[2], TD.GenerationConfig(max_new_tokens=max_new), device="cpu",
        **{**GEO, **kw})


PIPELINES = [dict(unified=True), dict(unified=False),
             dict(unified=True, prefix_cache=True),
             dict(unified=False, prefix_cache=True)]
PIPELINE_IDS = ["unified", "legacy", "unified_cache", "legacy_cache"]


@pytest.mark.parametrize("kw", PIPELINES, ids=PIPELINE_IDS)
def test_miss_record_matches_jax_engine(monkeypatch, kw):
    """The same storm builds the same programs in the same order: one
    ``cbe.unified_step`` (unified), or one ``cbe.decode_chunk`` and one
    ``cbe.prefill`` per ``(bucket, b_pad)`` / ``("sfx", bucket, b_pad)``
    (legacy). The unified key is the JAX engine's, the prefill flags
    included (the JAX legacy keys carry the chip count after them)."""
    want = []
    monkeypatch.setattr(JD.recompiles, "record_miss",
                        lambda name, key: want.append((name, key)))
    prompts = _storm(kw.get("prefix_cache", False))
    jeng = JD.ContinuousBatchingEngine(
        W[0], JD.GenerationConfig(max_new_tokens=6), **GEO, **kw)
    teng = _port_engine(**kw)
    assert teng.serve(W[3], prompts) == jeng.serve(W[1], prompts)
    got = teng.compile_misses
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(tuple(wk[:len(gk)]) == gk
               for (_, gk), (_, wk) in zip(got, want))
    names = {n for n, _ in got}
    if kw["unified"]:
        # (slots, chunk, step tokens, table width, fused tail, chips,
        # epilogue, A8W8 flag, the two fixed routing flags)
        assert got == [("cbe.unified_step", (2, 3, teng._step_tokens,
                                             teng._table_width, False, 1,
                                             False, True, True, True))]
        assert got == want
    else:
        assert names == {"cbe.prefill", "cbe.decode_chunk"}
        assert got.count(("cbe.decode_chunk", (2, 3))) == 1
        assert len(set(got)) == len(got)
        assert any(k[0] == "sfx" for _, k in got) == bool(
            kw.get("prefix_cache"))
    assert set(teng.compile_seconds) == names
    assert all(s > 0 for s in teng.compile_seconds.values())
    assert teng.capture_seconds == {n: 0.0 for n in names}   # no graphs


@pytest.mark.parametrize("kw", PIPELINES, ids=PIPELINE_IDS)
def test_params_swap_rebuilds_and_serves_the_new_weights(kw):
    """New weights on the same engine rebuild each program they run (one
    miss each, the same keys) and give the tokens of an engine that only
    ever saw them; serving them again rebuilds nothing."""
    other = _weights(5)[3]
    prompts = _prompts(4, (6, 13, 3, 9), seed=2)
    eng = _port_engine(**kw)
    first = eng.serve(W[3], prompts)
    n0 = len(eng.compile_misses)
    got = eng.serve(other, prompts)
    want = _port_engine(**kw).serve(other, prompts)
    if kw["unified"] or not kw.get("prefix_cache"):
        # the swap rebuilds exactly the first serve's programs (the
        # legacy cache's repeat runs warm waves instead: new keys)
        assert eng.compile_misses[n0:] == eng.compile_misses[:n0]
    if not kw.get("prefix_cache"):
        # (with the cache the repeat reuses the old weights' KV)
        assert got == want and got != first
    n1 = len(eng.compile_misses)
    eng.serve(other, prompts)
    if kw["unified"] or not kw.get("prefix_cache"):
        assert len(eng.compile_misses) == n1


def test_cache_swap_tokens_match_a_fresh_engine():
    """With the prefix cache, swapped weights still reach every layer:
    a cold serve after the swap (cache emptied) equals a fresh engine's
    serve of the new weights."""
    other = _weights(5)[3]
    prompts = _prompts(4, (6, 13, 3, 9), seed=2)
    eng = _port_engine(unified=False, prefix_cache=True)
    eng.serve(W[3], prompts)
    eng.cache.evict(eng.mgr.num_pages)
    n0 = len(eng.compile_misses)
    got = eng.serve(other, prompts)
    assert got == _port_engine(unified=False,
                               prefix_cache=True).serve(other, prompts)
    assert eng.compile_misses[n0:] and all(
        k[0] != "sfx" for _, k in eng.compile_misses[n0:])


def test_params_key_follows_the_tensors():
    p = W[3]
    assert params_key(p) == params_key(dict(p))
    q = dict(p, ln_f=p["ln_f"].clone())
    assert params_key(q) != params_key(p)


def test_program_runs_its_body_over_the_same_buffers_on_the_cpu():
    """Without graphs each call copies the host inputs into the static
    buffers and runs the body on them; the buffers never move."""
    seen = []

    def body(a, b):
        seen.append((a.data_ptr(), b.data_ptr()))
        return a * 2 + b.sum()

    inputs = dict(a=((3,), torch.int32), b=((2, 2), torch.int64))
    prog = Program(body, inputs, torch.device("cpu"), None)
    ptrs = (prog.static["a"].data_ptr(), prog.static["b"].data_ptr())
    for i in range(3):
        prog.host["a"][:] = [i, i + 1, i + 2]
        prog.host["b"].fill(i)
        out = prog()
        assert out.tolist() == [2 * i + 4 * i, 2 * i + 2 + 4 * i,
                                2 * i + 4 + 4 * i]
    assert prog.calls == 3 and set(seen) == {ptrs}
    assert prog.capture_seconds == 0.0


def test_rope_tables_are_never_evicted():
    """A captured graph reads the rope tables at their addresses, so the
    cache that holds them is unbounded."""
    assert TL._rope_cache.cache_info().maxsize is None


def _port_modules():
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        yield importlib.import_module(info.name)


def test_every_counted_kernel_wrapper_is_registered():
    """Every function of the port with a ``launches`` counter is in the
    registry (its replays would count nothing otherwise), with each of
    its counters in ``launch_counts``."""
    found = {id(v): v for m in _port_modules() for v in vars(m).values()
             if callable(v) and hasattr(v, "launches")}
    keys = _common.launch_counts()
    assert len(found) >= 10
    assert {id(fn) for fn, _ in keys} == set(found)
    for fn in found.values():
        assert (fn, None) in keys
        for r in getattr(fn, "route_launches", {}):
            assert (fn, r) in keys


def test_launch_counts_add_and_take_back():
    before = _common.launch_counts()
    delta = {(rn.rms_norm, None): 3}
    try:
        _common.add_launch_counts(delta, 2)
        assert rn.rms_norm.launches == before[(rn.rms_norm, None)] + 6
        _common.add_launch_counts(delta, -2)
        assert _common.launch_counts() == before
    finally:
        rn.rms_norm.launches = before[(rn.rms_norm, None)]
