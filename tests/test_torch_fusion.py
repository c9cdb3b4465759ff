"""The fusion pass of ``paddle_tpu_torch.jit.fusion`` against
``paddle_tpu.jit.fusion``'s on the CPU — every scenario of the
reference's ``tests/test_fusion.py`` written for the port (its
parameters are torch leaves whose ``.grad`` the optimizers read):

* the pass: artifact → plan → apply, stale and mismatched artifacts as
  deduplicated ``fusion_skipped`` events, idempotent installs, the
  active gauge following the targets' liveness; the same artifacts plan
  the same regions in both packages;
* the decode tail: fused storms (prefix cache on/off, mid-decode
  admissions, speculation) emit exactly the unfused engine's greedy
  tokens and the reference's fused engine's, with the same program
  builds; the packed plan's fast path equals the generic planner;
* the optimizer region: the fused step commits parameters and state
  bitwise equal to the eager ``Optimizer.step()`` for every optimizer
  family (Lamb included, held to the port's eager Lamb), under clips,
  a scheduler, multi-precision, hyperparameter mutation, gradient
  subsets and a state-dict resume, and within rtol 1e-5 of the
  reference's eager step.

The reference's ``stage_eager`` traces a jaxpr with contraction fences;
its port-written counterpart holds the port's staging mode bitwise to
the eager ops it replaces (``test_stage_eager_matches_eager_bits``)."""

import gc
import json

import numpy as np
import pytest
import torch

import jax
import paddle_tpu.inference.decoding as JD
import paddle_tpu.jit.fusion as JF
import paddle_tpu.models.llama as JL
from paddle_tpu.observability.events import \
    configure_event_log as j_configure  # noqa: F401  (reference side)

from paddle_tpu_torch.inference.decoding import (ContinuousBatchingEngine,
                                                 GenerationConfig)
from paddle_tpu_torch.jit import fusion as F
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.observability.events import configure_event_log
from paddle_tpu_torch.observability.profiling import chain_profiler
from paddle_tpu_torch.observability.runtime import recompiles, telemetry
from paddle_tpu_torch.optimizer import clip as C
from paddle_tpu_torch.optimizer import optimizer as O
from paddle_tpu_torch.optimizer.adamw import AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _engine(fused, prefix_cache=False, speculative=False, max_new=6,
            num_slots=2, chunk=3, **kw):
    cfg = L.llama_tiny(num_hidden_layers=2)
    eng = ContinuousBatchingEngine(
        cfg, GenerationConfig(max_new_tokens=max_new),
        num_slots=num_slots, page_size=4, max_seq_len=64, chunk=chunk,
        prefix_cache=prefix_cache, unified=True, fused_tail=fused,
        speculative=speculative, device="cpu", **kw)
    return cfg, eng


def _prompts(cfg, lens, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in lens]


_STORM_LENS = (5, 12, 3, 9, 17, 2, 7, 30)
_JPARAMS = {}


def _jparams():
    if not _JPARAMS:
        cfg = JL.llama_tiny(num_hidden_layers=2)
        _JPARAMS["j"] = JL.init_stacked_params(cfg, seed=3)
    return _JPARAMS["j"]


def _params(cfg):
    """The reference's seeded weights, carried across."""
    return L.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      _jparams()),
                               cfg, device="cpu")


def _artifact(chains, symbols=None, schema=1, kind="paddle_tpu.hot_chains"):
    return {"version": schema, "schema_version": schema, "kind": kind,
            "meta": {}, "workload": "test", "top_n": len(chains),
            "transitions": 0, "dropped_pairs": 0, "op_totals": {},
            "symbols": symbols or {},
            "chains": [{"ops": list(ops), "count": 5, "est_us": 100.0 - i}
                       for i, ops in enumerate(chains)]}


# ---------------------------------------------------------------------------
# the pass: artifact -> plan -> apply
# ---------------------------------------------------------------------------

def test_plan_maps_ranked_chains_to_regions():
    doc = _artifact([("cbe.plan_step", "cbe.unified_step",
                      "cbe.decode_tail"),
                     ("grad_clip", "optimizer_update"),
                     ("multiply", "add", "clip")])
    plan = F.FusionPass().plan(doc)
    names = [c.region.name for c in plan.candidates]
    assert names == ["decode_tail", "optimizer_chain"]
    assert plan.candidates[0].matched == ("cbe.unified_step",
                                          "cbe.decode_tail")
    assert {tuple(s["chain"]): s["reason"] for s in plan.skipped} == {
        ("multiply", "add", "clip"): "no-region"}
    jplan = JF.FusionPass().plan(doc)
    assert [c.region.name for c in jplan.candidates] == names
    assert [c.matched for c in jplan.candidates] == \
        [c.matched for c in plan.candidates]


def test_stale_artifact_skips_symbol_missing_never_raises():
    doc = _artifact([("cbe.unified_step_v0", "cbe.decode_tail_v0")],
                    symbols={"cbe.unified_step_v0": "paddle_tpu.old.sym",
                             "cbe.decode_tail_v0": None})
    plan = F.FusionPass().plan(doc)
    assert not plan.candidates
    assert plan.skipped[0]["reason"] == "symbol-missing"
    assert plan.skipped[0]["missing"] == ["cbe.unified_step_v0"]
    doc2 = _artifact([("grad_clip", "optimizer_update")])
    plan2 = F.FusionPass(resolver=lambda: {}).plan(doc2)
    assert not plan2.candidates
    assert plan2.skipped[0]["reason"] == "symbol-missing"


def test_schema_mismatch_skips_structured():
    for bad in (_artifact([], schema=99),
                _artifact([], kind="other.artifact"),
                ["not", "a", "dict"], None, {}):
        plan = F.FusionPass().plan(bad)
        assert not plan.candidates
        assert plan.skipped == [{"chain": ("<artifact>",),
                                 "reason": "schema-mismatch"}]


def test_fusion_skipped_event_deduped_per_chain(tmp_path):
    configure_event_log(str(tmp_path / "events.jsonl"))
    try:
        doc = _artifact([("mystery_op_a", "mystery_op_b")])
        F.FusionPass().plan(doc)
        F.FusionPass().plan(doc)      # second pass: no second event
        lines = [json.loads(x) for x in
                 (tmp_path / "events.jsonl").read_text().splitlines()]
        skips = [e for e in lines if e["kind"] == "fusion_skipped"
                 and e["chain"] == "mystery_op_a->mystery_op_b"]
        assert len(skips) == 1
        assert skips[0]["reason"] == "no-region"
    finally:
        configure_event_log(None)
    fam = get_registry().snapshot().get("paddle_fusion_skipped_total", {})
    assert any("no-region" in k for k in fam)


def test_apply_installs_on_duck_typed_targets():
    doc = _artifact([("cbe.unified_step", "cbe.decode_tail"),
                     ("optimizer_update", "optimizer_update")])
    plan = F.FusionPass().plan(doc)
    cfg, eng = _engine(False)
    opt = O.SGD(0.1, parameters=[torch.ones(4, 4)])
    installed = plan.apply(engine=eng, optimizer=opt)
    assert set(installed) == {"decode_tail", "optimizer_chain"}
    assert eng._fused_tail
    assert isinstance(opt._fused_step, F.FusedOptimizerStep)
    assert plan.apply(optimizer=opt)["optimizer_chain"] is opt._fused_step
    assert get_registry().snapshot().get("paddle_fusion_active", {})


def test_apply_on_rejecting_target_skips_never_raises():
    doc = _artifact([("cbe.unified_step", "cbe.decode_tail")])
    plan = F.FusionPass().plan(doc)
    legacy = ContinuousBatchingEngine(
        L.llama_tiny(num_hidden_layers=2), GenerationConfig(max_new_tokens=4),
        num_slots=2, page_size=4, max_seq_len=64, chunk=3, unified=False,
        device="cpu")
    assert plan.apply(engine=legacy) == {}
    assert not legacy._fused_tail
    fam = get_registry().snapshot().get("paddle_fusion_skipped_total", {})
    assert any("target-unsupported" in k for k in fam)
    with pytest.raises(ValueError, match="unified=True"):
        _engine(True, unified=False) if False else \
            ContinuousBatchingEngine(L.llama_tiny(), unified=False,
                                     fused_tail=True, device="cpu")


def test_apply_idempotent_counts_install_once():
    doc = _artifact([("cbe.unified_step", "cbe.decode_tail")])
    cfg, eng = _engine(False)

    def admitted():
        fam = get_registry().snapshot().get(
            "paddle_fusion_admitted_total", {})
        return sum(v for k, v in fam.items() if "decode_tail" in k)

    plan = F.FusionPass().plan(doc)
    plan.apply(engine=eng)
    once = admitted()
    plan.apply(engine=eng)
    F.FusionPass().plan(doc).apply(engine=eng)
    assert admitted() == once


def test_active_gauge_follows_install_target_liveness():
    doc = _artifact([("cbe.unified_step", "cbe.decode_tail")])
    plan = F.FusionPass().plan(doc)
    cfg, eng = _engine(False)
    plan.apply(engine=eng)

    def active():
        fam = get_registry().snapshot().get("paddle_fusion_active", {})
        return {k: v for k, v in fam.items() if "decode_tail" in k}

    assert all(v == 1 for v in active().values()) and active()
    del eng
    gc.collect()
    F.FusionPass().plan(doc)
    assert all(v == 0 for v in active().values())


def test_end_to_end_profile_plan_apply():
    """Arm the profiler over a real storm and an eager optimizer run,
    plan the artifact, install both regions."""
    cfg, eng = _engine(False)
    params = _params(cfg)
    telemetry.enable()
    chain_profiler.reset()
    chain_profiler.arm()
    try:
        eng.serve(params, _prompts(cfg, (5, 9, 13, 7)))
        ps = [(torch.ones(8, 4) * (i + 1)).requires_grad_(True)
              for i in range(3)]
        opt = AdamW(0.01, parameters=ps,
                    grad_clip=C.ClipGradByGlobalNorm(1.0))
        for _ in range(3):
            for p in ps:
                p.grad = torch.ones(8, 4)
            opt.step()
    finally:
        chain_profiler.disarm()
    doc = chain_profiler.profile(top_n=8, workload="e2e")
    plan = F.FusionPass().plan(doc)
    names = {c.region.name for c in plan.candidates}
    assert {"decode_tail", "optimizer_chain"} <= names
    cfg2, eng2 = _engine(False)
    installed = plan.apply(engine=eng2)
    assert "decode_tail" in installed and eng2._fused_tail


# ---------------------------------------------------------------------------
# decode tail: byte-identity + recompile neutrality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [False, True])
def test_fused_tail_storm_byte_identical(prefix_cache):
    cfg, base = _engine(False, prefix_cache=prefix_cache)
    params = _params(cfg)
    prompts = _prompts(cfg, _STORM_LENS)
    if prefix_cache:
        prompts[3] = np.concatenate([prompts[1], prompts[2]])
        prompts[5] = prompts[1].copy()
    want = base.serve(params, prompts)
    cfg2, fused = _engine(True, prefix_cache=prefix_cache)
    assert fused.serve(params, prompts) == want
    assert fused._unified_step.uploads == 3 * fused._unified_step.calls
    assert base._unified_step.uploads == 9 * base._unified_step.calls


def test_fused_tail_streams_match_reference_fused_engine():
    cfg, fused = _engine(True)
    prompts = _prompts(cfg, _STORM_LENS)
    got = fused.serve(_params(cfg), prompts)
    jeng = JD.ContinuousBatchingEngine(
        JL.llama_tiny(num_hidden_layers=2), JD.GenerationConfig(
            max_new_tokens=6), num_slots=2, page_size=4, max_seq_len=64,
        chunk=3, unified=True, fused_tail=True)
    want = [list(map(int, t)) for t in jeng.serve(_jparams(), prompts)]
    assert [list(map(int, t)) for t in got] == want


def test_fused_tail_recompile_neutral_across_storm():
    cfg = L.llama_tiny(num_hidden_layers=2)
    params = _params(cfg)
    counts = {}
    for fused in (False, True):
        before = recompiles.count("cbe.unified_step")
        cfg_, eng = _engine(fused, max_new=5)
        prompts = _prompts(cfg, _STORM_LENS)
        rids = [eng.submit(p) for p in prompts[:3]]
        done = {}
        step = 0
        while len(done) < len(prompts):
            eng.step(params)
            done.update(eng.collect())
            step += 1
            if step == 2:               # mid-decode trickle admission
                rids += [eng.submit(p) for p in prompts[3:]]
        counts[fused] = recompiles.count("cbe.unified_step") - before
    assert counts[True] == counts[False] == 1


def test_enable_fused_tail_mid_serve_stays_byte_identical():
    cfg, base = _engine(False, max_new=8, num_slots=2, chunk=2)
    params = _params(cfg)
    prompts = _prompts(cfg, (5, 9, 13, 7))
    want = base.serve(params, prompts)
    cfg2, eng = _engine(False, max_new=8, num_slots=2, chunk=2)
    rids = [eng.submit(p) for p in prompts]
    for _ in range(3):
        eng.step(params)
    eng.enable_fused_tail()
    done = dict(eng.collect())
    while len(done) < len(prompts):
        eng.step(params)
        done.update(eng.collect())
    assert [done[r] for r in rids] == want
    assert [m[1][4] for m in eng.compile_misses] == [False, True]


def test_plan_fast_path_matches_generic_planner():
    cfg, a = _engine(True, num_slots=4, chunk=5)
    cfg2, b = _engine(True, num_slots=4, chunk=5)
    for eng in (a, b):
        # synthetic steady state: slots 0 and 2 decoding, 1/3 idle
        eng._slot_rid[0], eng._slot_rid[2] = 11, 12
        eng._pos[0], eng._pos[2] = 7, 3
        eng._pend[0] = eng._pend[2] = None

    def host():
        K, tb, R = a.chunk, a._step_tokens, a.num_slots
        return {"plan_tt": np.zeros((5, K, tb), np.int32),
                "plan_tr": np.zeros((3, K, R), np.int32)}

    def generic(eng):
        plan = {n: np.zeros(s, np.int32 if dt == torch.int32 else bool)
                for n, (s, dt) in eng._unified_inputs().items()}
        emit, fed = eng._plan_step(plan)
        tt, tr = F.pack_plan(plan["ids"], plan["use_carry"],
                             plan["token_row"], plan["positions"],
                             plan["kv_lens"], plan["last_idx"],
                             plan["sample_mask"], decoding=plan["decoding"])
        return tt, tr, emit, fed

    ha = host()
    emit_f, fed_f = a._plan_step_packed(ha)
    tt_gen, tr_gen, emit_g, fed_g = generic(b)
    np.testing.assert_array_equal(ha["plan_tt"], tt_gen)
    np.testing.assert_array_equal(ha["plan_tr"], tr_gen)
    np.testing.assert_array_equal(emit_f, emit_g)
    assert fed_f == fed_g
    np.testing.assert_array_equal(a._pos, b._pos)
    # mixed round (one slot still prefilling): the generic planner
    a._pend[0] = np.asarray([1, 2, 3], np.int32)
    b._pend[0] = np.asarray([1, 2, 3], np.int32)
    ha = host()
    a._plan_step_packed(ha)
    tt_gen, tr_gen, _, _ = generic(b)
    np.testing.assert_array_equal(ha["plan_tt"], tt_gen)
    np.testing.assert_array_equal(ha["plan_tr"], tr_gen)


def test_spec_composition_byte_identical():
    cfg, plain = _engine(False)
    params = _params(cfg)
    prompts = _prompts(cfg, _STORM_LENS)
    want = plain.serve(params, prompts)
    for fused, spec in ((True, False), (False, True), (True, True)):
        cfg2, eng = _engine(fused, speculative=spec, step_tokens=10)
        assert eng.serve(params, prompts) == want, (fused, spec)


def test_fused_spec_recompile_neutral():
    cfg = L.llama_tiny(num_hidden_layers=2)
    params = _params(cfg)
    counts = {}
    for fused in (False, True):
        before = recompiles.count("cbe.spec_step")
        cfg2, eng = _engine(fused, speculative=True, step_tokens=10)
        eng.serve(params, _prompts(cfg, _STORM_LENS))
        counts[fused] = recompiles.count("cbe.spec_step") - before
        if fused:
            assert eng._spec_step.uploads == 3 * eng._spec_step.calls
    assert counts[True] == counts[False] == 1


# ---------------------------------------------------------------------------
# optimizer chain: bitwise across every optimizer family
# ---------------------------------------------------------------------------

_SHAPES = ((32, 16), (16,), (64, 8), (24,), (4, 4, 3))


def _fresh_params(mults=True, dtype=torch.float32):
    rng = np.random.RandomState(42)
    named = []
    for i, s in enumerate(_SHAPES):
        p = torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
        p.requires_grad_(True)
        if mults and i % 2:
            p.optimize_attr = {"learning_rate": 0.5}
        named.append((f"p_{i}", p))
    return named


def _grad_seq(steps):
    return [[np.random.RandomState(100 + k + i).randn(*s).astype(np.float32)
             for i, s in enumerate(_SHAPES)]
            for k in range(steps)]


def _set_grads(named, grads, only=None):
    for i, ((_, p), g) in enumerate(zip(named, grads)):
        if only is None or i in only:
            p.grad = torch.from_numpy(g).to(p.dtype)


def _run(make_opt, fused, steps=4):
    named = _fresh_params()
    opt = make_opt(named)
    if fused:
        F.install_optimizer_fusion(opt)
    for grads in _grad_seq(steps):
        _set_grads(named, grads)
        opt.step()
    return named, opt


def _assert_bitwise(make_opt, steps=4):
    pe, oe = _run(make_opt, fused=False, steps=steps)
    pf, of = _run(make_opt, fused=True, steps=steps)
    assert of._fused_step.steps_fused == steps
    for (n, a), (_, b) in zip(pe, pf):
        assert torch.equal(a, b), f"param {n} drifted"
        se, sf = oe.state.get(n, {}), of.state.get(n, {})
        assert se.keys() == sf.keys()
        for k in se:
            assert torch.equal(se[k], sf[k]), f"state {n}.{k} drifted"


_CLIP = lambda: C.ClipGradByGlobalNorm(1.0)  # noqa: E731

FAMILIES = {
    "sgd": lambda ps: O.SGD(0.01, parameters=ps, weight_decay=0.01),
    "momentum_nesterov":
        lambda ps: O.Momentum(0.01, 0.9, parameters=ps, use_nesterov=True,
                              weight_decay=0.01, grad_clip=_CLIP()),
    "adam": lambda ps: O.Adam(0.003, parameters=ps, weight_decay=0.01),
    "adamw_clip_decayfn":
        lambda ps: AdamW(0.01, parameters=ps, weight_decay=0.05,
                         apply_decay_param_fun=lambda n: not n.endswith("2"),
                         grad_clip=_CLIP()),
    "adamax": lambda ps: O.Adamax(0.01, parameters=ps, weight_decay=0.01),
    "lamb": lambda ps: O.Lamb(0.01, parameters=ps),
    "rmsprop_centered":
        lambda ps: O.RMSProp(0.01, centered=True, momentum=0.9,
                             parameters=ps, weight_decay=0.01),
    "adagrad": lambda ps: O.Adagrad(0.01, parameters=ps, weight_decay=0.01),
    "clip_by_value":
        lambda ps: O.SGD(0.01, parameters=ps,
                         grad_clip=C.ClipGradByValue(0.1)),
    "clip_by_norm":
        lambda ps: O.Momentum(0.01, 0.9, parameters=ps,
                              grad_clip=C.ClipGradByNorm(0.5)),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_fused_optimizer_bitwise_identical(name):
    _assert_bitwise(FAMILIES[name])


def test_fused_adam_matches_reference_eager_step():
    """The fused port step against the reference's eager Adam on the
    same parameters and gradients (rtol 1e-5)."""
    from paddle_tpu.core.tensor import Parameter
    from paddle_tpu.optimizer import optimizer as JO
    import jax.numpy as jnp
    pf, _ = _run(FAMILIES["adam"], fused=True)
    rng = np.random.RandomState(42)
    jps = []
    for i, s in enumerate(_SHAPES):
        p = Parameter(jnp.asarray(rng.randn(*s).astype(np.float32)))
        p.name = f"p_{i}"
        if i % 2:
            p.optimize_attr["learning_rate"] = 0.5
        jps.append(p)
    jo = JO.Adam(0.003, parameters=jps, weight_decay=0.01)
    for grads in _grad_seq(4):
        for p, g in zip(jps, grads):
            p._grad_value = jnp.asarray(g)
        jo.step()
    for (n, a), b in zip(pf, jps):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._value),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_fused_optimizer_with_lr_scheduler_bitwise():
    def factory(ps):
        return O.Adam(StepDecay(0.01, step_size=2, gamma=0.5), parameters=ps)

    pe, _ = _run(factory, fused=False, steps=5)
    pf, _ = _run(factory, fused=True, steps=5)
    for (_, a), (_, b) in zip(pe, pf):
        assert torch.equal(a, b)


def test_fused_optimizer_multi_precision_bitwise():
    def run(fused):
        named = _fresh_params(mults=False, dtype=torch.bfloat16)
        opt = AdamW(0.01, parameters=named, weight_decay=0.05,
                    multi_precision=True)
        if fused:
            F.install_optimizer_fusion(opt)
        for grads in _grad_seq(3):
            _set_grads(named, grads)
            opt.step()
        return named, opt

    pe, oe = run(False)
    pf, of = run(True)
    for (n, a), (_, b) in zip(pe, pf):
        assert torch.equal(a, b), f"bf16 param {n}"
        assert torch.equal(oe.state[n]["master"], of.state[n]["master"])


def test_fused_optimizer_rebuilds_on_hyperparameter_mutation():
    def run(fused):
        named = _fresh_params()
        opt = AdamW(0.01, parameters=named, weight_decay=0.05,
                    grad_clip=C.ClipGradByGlobalNorm(1.0))
        if fused:
            F.install_optimizer_fusion(opt)
        for k, grads in enumerate(_grad_seq(4)):
            if k == 2:
                opt._grad_clip.clip_norm = 0.25
                opt._weight_decay = 0.2
            _set_grads(named, grads)
            opt.step()
        return named, opt

    pe, _ = run(False)
    pf, of = run(True)
    for (n, a), (_, b) in zip(pe, pf):
        assert torch.equal(a, b), f"param {n}"
    assert len(of._fused_step._compiled) == 2


def test_fused_optimizer_raise_in_first_step_leaves_weights_and_state():
    """A raise inside the first fused step's dry pass, after its updates
    ran, leaves the real parameters and state as they were; the next
    step learns its slots again and commits the eager step's bits."""
    class Faulty(O.Adam):
        faults = 0

        def _apply(self, items, t):
            super()._apply(items, t)
            if self.faults:
                self.faults -= 1
                raise RuntimeError("injected")

    grads = _grad_seq(2)
    named = _fresh_params()
    opt = Faulty(0.003, parameters=named, weight_decay=0.01)
    _set_grads(named, grads[0])
    opt.step()                                  # eager: the state is live
    before = ([p.detach().clone() for _, p in named],
              {n: {k: v.clone() for k, v in s.items()}
               for n, s in opt.state.items()})
    fused = F.install_optimizer_fusion(opt)
    opt.faults = 1
    _set_grads(named, grads[1])
    with pytest.raises(RuntimeError, match="injected"):
        opt.step()
    for (n, p), want in zip(named, before[0]):
        assert torch.equal(p.detach(), want), n
    for n, st in before[1].items():
        for k, v in st.items():
            assert torch.equal(opt.state[n][k], v), (n, k)
    assert [prog.stager.slots for prog in fused._compiled.values()] == [[]]
    opt.step()

    ref = _fresh_params()
    eager = O.Adam(0.003, parameters=ref, weight_decay=0.01)
    _set_grads(ref, grads[0])
    eager.step()
    eager._step_count += 1                      # the step that raised
    _set_grads(ref, grads[1])
    eager.step()
    for (n, a), (_, b) in zip(named, ref):
        assert torch.equal(a, b), n
    for n in eager.state:
        for k in eager.state[n]:
            assert torch.equal(opt.state[n][k], eager.state[n][k]), (n, k)


def test_fused_optimizer_compiles_once_and_reuses():
    before = recompiles.count("fusion.optimizer_chain")
    _run(lambda ps: O.Adam(0.003, parameters=ps), fused=True, steps=6)
    assert recompiles.count("fusion.optimizer_chain") - before == 1


def test_fused_optimizer_grad_subset_rebuilds_correctly():
    def run(fused):
        named = _fresh_params()
        opt = O.Adam(0.01, parameters=named, weight_decay=0.01)
        if fused:
            F.install_optimizer_fusion(opt)
        grads = _grad_seq(2)
        _set_grads(named, grads[0])
        opt.step()
        opt.clear_grad()
        _set_grads(named, grads[1], only=(0, 2, 4))
        opt.step()
        return named

    for (n, a), (_, b) in zip(run(False), run(True)):
        assert torch.equal(a, b), n


def test_fused_optimizer_state_dict_round_trip():
    def factory(ps):
        return O.Adam(0.01, parameters=ps)

    pe, oe = _run(factory, fused=False, steps=2)
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in oe.state_dict().items()}
    for grads in _grad_seq(2):
        _set_grads(pe, grads)
        oe.step()
    pf, _ = _run(factory, fused=False, steps=2)
    opt2 = factory(pf)
    opt2.set_state_dict(state)
    F.install_optimizer_fusion(opt2)
    for grads in _grad_seq(2):
        _set_grads(pf, grads)
        opt2.step()
    for (_, a), (_, b) in zip(pe, pf):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# staging mechanics
# ---------------------------------------------------------------------------

def test_stage_eager_matches_eager_bits():
    """The staging mode itself: a chain of products, sums and divisions
    by host scalars (the bias corrections' shape), staged with ``lr`` and
    ``step`` as host scalars, reproduces the eager per-op bits for every
    step's values."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 32).astype(np.float32))

    def chain(lr, step, x, y):
        m = 0.9 * x + (1 - 0.9) * y
        v = 0.999 * torch.abs(x) + (1 - 0.999) * (y * y)
        bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        out = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        return x - lr * out + 2.0 / (lr * 10 + out.abs() + 1)

    staged, stager = F.stage_eager(chain)
    vec = torch.zeros(16)
    staged(vec, a, b)                         # learn the slots
    for lr, step in ((0.01, 1), (0.003, 7), (0.5, 120)):
        stager.env = {"lr": lr, "step": step}
        host = np.zeros(16, np.float32)
        stager.values(host)
        vec.copy_(torch.from_numpy(host))
        assert torch.equal(staged(vec, a, b), chain(lr, step, a, b))


def test_pack_plan_round_trip():
    K, tb, R = 3, 6, 2
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (K, tb)).astype(np.int32)
    uc = rng.rand(K, tb) > 0.5
    dec = rng.rand(K, tb) > 0.5
    tr = rng.randint(-1, R, (K, tb)).astype(np.int32)
    pos = rng.randint(0, 50, (K, tb)).astype(np.int32)
    kvl = rng.randint(0, 50, (K, R)).astype(np.int32)
    li = rng.randint(0, tb, (K, R)).astype(np.int32)
    sm = rng.rand(K, R) > 0.5
    tt, trr = F.pack_plan(ids, uc, tr, pos, kvl, li, sm, decoding=dec)
    jtt, jtr = JF.pack_plan(ids, uc, tr, pos, kvl, li, sm)
    # the reference's four token-axis rows and three row-axis rows, with
    # the port's decoding flags as the third token-axis row
    assert tt.shape == (5, K, tb) and trr.shape == (3, K, R)
    np.testing.assert_array_equal(tt[[0, 1, 3, 4]], jtt)
    np.testing.assert_array_equal(tt[2].astype(bool), dec)
    np.testing.assert_array_equal(trr, jtr)
    # the fused step reads the plan back: each round's model inputs are
    # the plan's rows (the carry token where use_carry)
    seen = []

    def model_step(ids_eff, token_row, positions, kv_lens, last_idx, bt,
                   gst, decoding):
        seen.append((ids_eff.clone(), token_row, positions, kv_lens,
                     last_idx, decoding))
        return torch.zeros(R, 5)

    run = F.build_fused_unified_step(
        model_step, lambda lg, kvl, g: (torch.full((R,), 7, dtype=torch.int32),
                                        g), R)
    tok = torch.arange(R, dtype=torch.int32)
    out = run(torch.from_numpy(tt), torch.from_numpy(trr), None, tok,
              torch.zeros(R, dtype=torch.int32))
    for k, (ide, trk, pk, kvk, lik, dk) in enumerate(seen):
        np.testing.assert_array_equal(trk.numpy(), tr[k])
        np.testing.assert_array_equal(pk.numpy(), pos[k])
        np.testing.assert_array_equal(kvk.numpy(), kvl[k])
        np.testing.assert_array_equal(lik.numpy(), li[k])
        np.testing.assert_array_equal(dk.numpy(), dec[k])
    np.testing.assert_array_equal(out[0].numpy(), np.arange(R))
