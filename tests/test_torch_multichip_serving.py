"""Tensor-parallel serving: the port's ``ContinuousBatchingEngine(mesh=)``
over a serving mesh of CPU chips against the JAX package's engine over
its serving mesh on the 8 virtual CPU devices (the conftest's), as
``test_multichip_serving.py`` and ``test_sampling.py``'s sharded replay
run it.

The port's mesh is one process's devices (``parallel.mesh.ServingMesh``):
here ``[torch.device("cpu")] * n``, n logical chips on one device, each
with its own weight and pool slabs. The weights are the JAX package's
(``init_stacked_params(seed=3)``) carried across through numpy, fp32.
Greedy and seeded sampled tokens must be identical to the JAX engine's
at every degree; each chip's slabs must equal the JAX array's shard on
the same chip (weights bitwise; pools to fp32 rounding: the two packages'
products round differently)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.decoding import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.decoding import GenerationConfig as JGen
from paddle_tpu.inference.sampling import SamplerConfig as JSampler
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.inference.sampling import SamplerConfig as TSampler
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability.runtime import recompiles
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

JCFG = JL.llama_tiny(num_hidden_layers=2)
JPARAMS = JL.init_stacked_params(JCFG, seed=3)
CFG = TL.llama_tiny(num_hidden_layers=2)
PARAMS = TL.params_from_numpy({k: np.asarray(v) for k, v in JPARAMS.items()},
                              CFG, "cpu")
CPU = torch.device("cpu")
#: the pools of the two packages' serves, per element: fp32 K/V made by
#: products that round in another order (XLA against torch on the CPU)
POOL_TOL = dict(rtol=1e-5, atol=1e-6)


def _tmesh(mp):
    return tmesh.serving_mesh(mp, [CPU] * mp) if mp > 1 else None


def _jmesh(mp):
    return jmesh.serving_mesh(mp) if mp > 1 else None


def _geo(max_new=6, num_slots=2, **kw):
    return dict(num_slots=num_slots, page_size=4, max_seq_len=64, chunk=2,
                **kw)


def _tengine(mp, max_new=6, **kw):
    return TD.ContinuousBatchingEngine(
        CFG, TD.GenerationConfig(max_new_tokens=max_new, seed=3),
        mesh=_tmesh(mp), device="cpu", **_geo(**kw))


def _jengine(mp, max_new=6, **kw):
    return JEngine(JCFG, JGen(max_new_tokens=max_new, seed=3),
                   mesh=_jmesh(mp), **_geo(**kw))


def _prompts(n, lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size,
                        (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


# ---------------------------------------------------------------------------
# tokens equal the JAX engine's at every degree
# ---------------------------------------------------------------------------

def _serve_both_ways(make, params, prompts, prefix_cache):
    out = {}
    for mp in (1, 2, 4):
        eng = make(mp, prefix_cache=prefix_cache)
        cold = eng.serve(params, prompts)
        warm = eng.serve(params, prompts) if prefix_cache else None
        out[mp] = (cold, warm, eng.num_chips)
    return out


@pytest.fixture(scope="module")
def reference_serves():
    """The JAX engine's serves of ``test_byte_identity_across_mp_degrees``
    at mp 1, 2 and 4, by (prefix_cache, speculative)."""
    prompts = _prompts(5, (5, 9, 3, 12, 7))
    return prompts, {
        (pc, spec): _serve_both_ways(
            lambda mp, **kw: _jengine(mp, speculative=spec, **kw), JPARAMS,
            prompts, pc)
        for pc in (False, True) for spec in (False, True)}


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("speculative", [False, True])
def test_byte_identity_across_mp_degrees(reference_serves, prefix_cache,
                                         speculative):
    """The port's engine at mp 1, 2 and 4 emits the JAX engine's greedy
    tokens at each degree; with the prefix cache the second serve is the
    warm pass (full-prompt hits copy a page on every chip's slab)."""
    prompts, ref = reference_serves
    got = _serve_both_ways(
        lambda mp, **kw: _tengine(mp, speculative=speculative, **kw),
        PARAMS, prompts, prefix_cache)
    want = ref[(prefix_cache, speculative)]
    for mp in (1, 2, 4):
        assert got[mp] == want[mp], mp
        assert got[mp][2] == mp
    assert got[1][0] == got[2][0] == got[4][0]
    if prefix_cache:
        assert got[1][1] == got[1][0]


def test_sharded_storm_o1_recompiles_and_program_identity():
    """A length-diverse storm with mid-decode admissions at mp 2: at most
    two misses of ``cbe.unified_step`` (the reference's bound), one
    program object every round, and the JAX mp-2 engine's tokens."""
    prompts = _prompts(12, (2, 3, 5, 7, 9, 12, 17, 23, 31, 44))

    def storm(eng, params, count):
        u0 = count("cbe.unified_step")
        rids = [eng.submit(p) for p in prompts[:6]]
        results, step, prog = {}, 0, None
        while len(results) < len(prompts):
            eng.step(params)
            if prog is None:
                prog = eng._unified_step
            assert eng._unified_step is prog
            results.update(eng.collect())
            step += 1
            if step == 2:
                rids += [eng.submit(p) for p in prompts[6:]]
            assert step < 500
        assert count("cbe.unified_step") - u0 <= 2
        return [results[r] for r in rids]

    from paddle_tpu.observability.runtime import recompiles as jrecompiles
    teng = _tengine(2, max_new=4, num_slots=4)
    got = storm(teng, PARAMS, recompiles.count)
    assert [n for n, _ in teng.compile_misses] == ["cbe.unified_step"]
    assert teng.compile_misses[0][1][5] == 2          # the key's chips
    want = storm(_jengine(2, max_new=4, num_slots=4), JPARAMS,
                 jrecompiles.count)
    assert got == want
    assert _tengine(1, max_new=4, num_slots=4).serve(PARAMS, prompts) == got


# ---------------------------------------------------------------------------
# placement: each chip's slabs are the JAX array's shard on that chip
# ---------------------------------------------------------------------------

def _shard_on(arr, c):
    """The data of ``arr``'s shard on device ``c`` of the JAX mesh."""
    dev = jax.devices()[c]
    shard, = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def test_shard_params_tp_placements():
    """Column-parallel QKV/gate/up, row-parallel wo/down, whole
    embed/lm_head/norms: chip c's tensor equals the JAX array's shard on
    device c, bitwise; whole tensors stay the caller's on a shared
    device. Int8 leaves (``wq`` column-, ``wo`` row-parallel): each
    chip's ``q`` and ``scale`` slabs equal the JAX device shards."""
    jplaced = JL.shard_params_tp(JPARAMS, jmesh.serving_mesh(4), JCFG)
    placed = TL.shard_params_tp(PARAMS, _tmesh(4), CFG)
    assert len(placed) == 4
    for c, chip in enumerate(placed):
        assert list(chip) == list(PARAMS)
        for k, v in chip.items():
            np.testing.assert_array_equal(v.numpy(),
                                          _shard_on(jplaced[k], c), k)
            assert v.is_contiguous()
        assert chip["embed"] is PARAMS["embed"]
    assert placed[0]["wq"].shape[2] == PARAMS["wq"].shape[2] // 4
    assert placed[0]["wo"].shape[1] == PARAMS["wo"].shape[1] // 4
    one = TL.shard_params_tp(PARAMS, tmesh.serving_mesh(1, [CPU]), CFG)
    assert all(one[k] is PARAMS[k] for k in PARAMS)
    from paddle_tpu.quantization import quantize_stacked_params
    qp = quantize_stacked_params(JPARAMS, keys=("wq", "wo"))
    jq = JL.shard_params_tp(qp, jmesh.serving_mesh(4), JCFG)
    int8 = dict(PARAMS, **{w: {k: torch.from_numpy(np.array(v))
                               for k, v in qp[w].items()}
                           for w in ("wq", "wo")})
    placed = TL.shard_params_tp(int8, _tmesh(4), CFG)
    for c, chip in enumerate(placed):
        for w in ("wq", "wo"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    chip[w][part].numpy(), _shard_on(jq[w][part], c),
                    (w, part))
    assert placed[0]["wq"]["scale"].shape[1] == \
        qp["wq"]["scale"].shape[1] // 4           # column-parallel scale
    assert placed[0]["wo"]["scale"].shape == qp["wo"]["scale"].shape


def test_pool_head_sharding_and_validation():
    """The pools head-shard over mp (whole GQA groups per chip, one
    contiguous slab a chip) and after a serve each chip's slab holds the
    JAX pool's shard on that chip; bad degrees fail at construction."""
    prompts = _prompts(3, (5, 9, 3))
    for mp in (2, 4):
        teng, jeng = _tengine(mp), _jengine(mp)
        assert teng.mgr.mesh_chips == mp
        assert isinstance(teng.mgr.k_pages, tpa.HeadShards)
        assert teng.mgr.k_pages.shape == (2, teng.mgr.num_pages, 4,
                                          CFG.num_key_value_heads, 16)
        assert teng.serve(PARAMS, prompts) == jeng.serve(JPARAMS, prompts)
        for tp, jp in ((teng.mgr.k_pages, jeng.mgr.k_pages),
                       (teng.mgr.v_pages, jeng.mgr.v_pages)):
            for c, slab in enumerate(tp.slabs):
                assert slab.is_contiguous()
                assert slab.shape[3] == CFG.num_key_value_heads // mp
                # page 0 is the pad tokens' page: its slots take the
                # last of several pad writes, in either package's order
                np.testing.assert_allclose(slab.numpy()[:, 1:],
                                           _shard_on(jp, c)[:, 1:],
                                           **POOL_TOL)
    with pytest.raises(ValueError, match="divide"):
        TD.ContinuousBatchingEngine(
            CFG, TD.GenerationConfig(max_new_tokens=4), num_slots=2,
            page_size=4, max_seq_len=32, mesh=_tmesh(3), device="cpu")
    with pytest.raises(ValueError, match="unified"):
        TD.ContinuousBatchingEngine(
            CFG, TD.GenerationConfig(max_new_tokens=4), num_slots=2,
            page_size=4, max_seq_len=32, unified=False, mesh=_tmesh(2),
            device="cpu")
    with pytest.raises(ValueError, match="first device"):
        TD.ContinuousBatchingEngine(CFG, mesh=_tmesh(2), device="meta")


def test_mesh_resize_helpers():
    """Surviving-degree math and the shrink, against the reference's
    helpers; a chip keeps its name after a shrink."""
    for left, nkv in ((4, 4), (3, 4), (2, 4), (1, 4), (5, 6)):
        assert tmesh.surviving_mp_degree(left, nkv) == \
            jmesh.surviving_mp_degree(left, nkv)
    m4 = tmesh.serving_mesh(4, [CPU] * 4)
    assert m4.shape == {"mp": 4} and m4.axis_names == ("mp",)
    assert m4.devices.reshape(-1).tolist() == [CPU] * 4
    m2 = tmesh.shrink_serving_mesh(m4, 1, 4)
    j2 = jmesh.shrink_serving_mesh(jmesh.serving_mesh(4), 1, 4)
    assert m2.shape["mp"] == j2.shape["mp"] == 2
    assert m2.chips == tuple(d.id for d in j2.devices.reshape(-1)) == (0, 2)
    for bad in (0, 9):
        with pytest.raises(ValueError):
            tmesh.serving_mesh(bad, [CPU] * 8)
        with pytest.raises(ValueError):
            jmesh.serving_mesh(bad)
    with pytest.raises(ValueError, match="outside"):
        tmesh.shrink_serving_mesh(m4, 4, 4)
    with pytest.raises(ValueError, match="outside"):
        jmesh.shrink_serving_mesh(jmesh.serving_mesh(4), 4, 4)
    # the one-process all-reduce sums the chips' partials in chip order
    parts = [torch.full((3,), float(2 ** c)) for c in range(4)]
    out = tmesh.serving_all_reduce(parts)
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert out[0].tolist() == [15.0] * 3


def test_sharded_wrapper_interpret_parity():
    """``ragged_paged_attention(mesh=)`` (the plain version on each chip's
    head slab, joined on heads) against the reference's shard_map wrapper
    around the Pallas kernel in interpret mode; and each chip's output is
    the whole call's head slice bitwise."""
    from paddle_tpu.ops import paged_attention as jpa
    rng = np.random.RandomState(0)
    n_rows, width, page, nkv, nh, d, T = 3, 4, 4, 4, 8, 8, 10
    pool = n_rows * width + 1
    kp = rng.randn(pool, page, nkv, d).astype(np.float32)
    vp = rng.randn(pool, page, nkv, d).astype(np.float32)
    q = rng.randn(T, nh, d).astype(np.float32)
    bt = np.zeros((n_rows, width), np.int32)
    for r in range(n_rows):
        bt[r] = 1 + r * width + np.arange(width)
    token_row = np.array([0, 0, 0, 1, 1, 2, -1, -1, -1, -1], np.int32)
    positions = np.array([0, 1, 2, 5, 6, 3, 0, 0, 0, 0], np.int32)
    kv_lens = np.array([3, 7, 4], np.int32)
    meta = (bt, token_row, positions, kv_lens)
    real = token_row >= 0
    targs = [torch.from_numpy(a) for a in (q, kp, vp) + meta]
    whole = tpa.ragged_paged_attention(*targs).numpy()
    for mp in (2, 4):
        want = jpa._ragged_paged_attention_shard_mapped(
            *(jnp.asarray(a) for a in (q, kp, vp) + meta), None,
            jmesh.serving_mesh(mp), "mp", interpret=True)
        got = tpa.ragged_paged_attention(*targs, mesh=_tmesh(mp)).numpy()
        np.testing.assert_allclose(got[real], np.asarray(want)[real],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(got, whole)
        # the same on the manager's slabs, chip by chip
        ks = tpa.HeadShards.split(targs[1], [CPU] * mp)
        vs = tpa.HeadShards.split(targs[2], [CPU] * mp)
        outs = tpa.ragged_paged_attention_chips(
            tpa.split_heads(targs[0], mp, [CPU] * mp), ks.slabs, vs.slabs,
            *targs[3:])
        for c, o in enumerate(outs):
            k = nh // mp
            np.testing.assert_array_equal(o.numpy(),
                                          whole[:, c * k:(c + 1) * k])


def test_memory_ledger_per_chip_split():
    """The memory ledger's pool books carry the TP degree: per-chip bytes
    are class bytes / chips, as in the reference's ledger."""
    from paddle_tpu.observability.memory import memory_ledger as jledger
    from paddle_tpu_torch.observability.memory import memory_ledger
    prompts = _prompts(3, (5, 9, 3))
    pools = []
    for ledger, eng, params in (
            (memory_ledger, _tengine(2, prefix_cache=True), PARAMS),
            (jledger, _jengine(2, prefix_cache=True), JPARAMS)):
        ledger.reset()
        ledger.arm()
        try:
            eng.serve(params, prompts)
            snap = ledger.snapshot()
        finally:
            ledger.disarm()
            ledger.reset()
        pool = next(p for p in snap["pools"]
                    if p["num_pages"] == eng.mgr.num_pages)
        assert pool["chips"] == 2
        for cls, b in pool["bytes"].items():
            assert pool["bytes_per_chip"][cls] == b // 2
        assert sum(pool["bytes"].values()) == \
            pool["usable_pages"] * pool["page_bytes"]
        pools.append({k: pool[k] for k in ("chips", "page_bytes",
                                           "pool_bytes", "bytes",
                                           "bytes_per_chip")})
    assert pools[0] == pools[1]


def test_fused_tail_composes_with_mesh():
    """The fused decode tail rides the sharded step: fused x mp 2, the
    speculative flavour too, equals the JAX single-chip engine."""
    prompts = _prompts(3, (5, 9, 3))
    base = _jengine(1).serve(JPARAMS, prompts)
    assert _tengine(2, fused_tail=True).serve(PARAMS, prompts) == base
    assert _tengine(2, fused_tail=True,
                    speculative=True).serve(PARAMS, prompts) == base


def _sampling_prompts(n=3, lens=(4, 12), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size,
                        (int(rng.randint(*lens)),)).astype(np.int32)
            for _ in range(n)]


def _run_sampled(eng, params, prompts, sc):
    rids = [eng.submit(p, sampler=sc) for p in prompts]
    out, steps = {}, 0
    while len(out) < len(prompts):
        eng.step(params)
        out.update(eng.collect())
        steps += 1
        assert steps < 3000
    return [out[r] for r in rids]


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_seeded_replay_sharded(mp):
    """``test_sampling.py``'s sharded replay: a seeded sampler gives the
    same stream twice at every degree, and the JAX engine's stream at
    that degree (its weights of seed 0, page 16)."""
    jp = JL.init_stacked_params(JCFG, seed=0)
    tparams = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   CFG, "cpu")
    prompts = _sampling_prompts()
    kw = dict(num_slots=2, page_size=16, max_seq_len=64, chunk=2)
    sc = dict(temperature=0.8, top_p=0.9, seed=5)

    def teng():
        return TD.ContinuousBatchingEngine(
            CFG, TD.GenerationConfig(max_new_tokens=8), mesh=_tmesh(mp),
            device="cpu", **kw)
    a = _run_sampled(teng(), tparams, prompts, TSampler(**sc))
    b = _run_sampled(teng(), tparams, prompts, TSampler(**sc))
    assert a == b and len(a[0]) == 8
    jeng = JEngine(JCFG, JGen(max_new_tokens=8), mesh=_jmesh(mp),
                   **kw)
    assert a == _run_sampled(jeng, jp, prompts, JSampler(**sc))


def test_sharded_pool_page_export_and_import():
    """Page migration over a head-sharded pool: ``export_page`` gives the
    frame an unsharded pool gives (its heads joined in chip order; the
    JAX pool's global page to fp32 rounding), ``write_page`` takes each
    chip's heads back into its slab, and ``import_prefix`` into a
    sharded cache serves the warm prompt with the JAX engine's tokens."""
    prompts = _prompts(2, (9, 12))
    engines = {mp: _tengine(mp, prefix_cache=True) for mp in (1, 2, 4)}
    outs = {mp: e.serve(PARAMS, prompts) for mp, e in engines.items()}
    jeng = _jengine(2, prefix_cache=True)
    assert outs[1] == outs[2] == outs[4] == jeng.serve(JPARAMS, prompts)
    pages = engines[2].cache.tree.match(list(prompts[1][:8]), touch=False)
    assert len(pages) == 2
    jpages = jeng.cache.tree.match(list(prompts[1][:8]), touch=False)
    for nd, jnd in zip(pages, jpages):
        k1, v1 = engines[1].mgr.export_page(nd.page)
        for mp in (2, 4):
            mgr = engines[mp].mgr
            k, v = mgr.export_page(nd.page)
            assert k.shape == k1.shape == (2, 4, CFG.num_key_value_heads, 16)
            np.testing.assert_allclose(k, k1, **POOL_TOL)
            np.testing.assert_allclose(v, v1, **POOL_TOL)
            joined = torch.cat([s[:, nd.page] for s in mgr.k_pages.slabs],
                               dim=-2).numpy()
            np.testing.assert_array_equal(k, joined)
            # write it into a free page and read it back, bitwise
            free, = mgr.take_free_pages(1)
            mgr.write_page(free, k, v)
            k2, v2 = mgr.export_page(free)
            np.testing.assert_array_equal(k2, k)
            np.testing.assert_array_equal(v2, v)
            mgr.give_back_pages([free])
        jk, _ = jeng.mgr.export_page(jnd.page)
        np.testing.assert_allclose(k1, np.asarray(jk), **POOL_TOL)
    # a migrated prefix into a fresh sharded cache, then a warm serve
    k_slabs, v_slabs = zip(*(engines[1].mgr.export_page(nd.page)
                             for nd in pages))
    dst = _tengine(4, prefix_cache=True)
    got = dst.cache.import_prefix(list(prompts[1][:8]), k_slabs, v_slabs)
    assert got["imported_pages"] == 2
    dst.mgr.check_conservation()
    assert dst.serve(PARAMS, [prompts[1]]) == [outs[1][1]]
    assert dst.cache.stats["hits"] >= 1
