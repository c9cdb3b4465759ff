"""The training recipe's eager API: the port's optimizer families,
gradient clips, learning-rate schedulers and the optimizer base
(``paddle_tpu_torch.optimizer``) against the JAX package's eager
``paddle_tpu.optimizer`` on the CPU, on the same numpy-seeded weights and
the same gradient sequence (``p._grad_value`` there, ``p.grad`` here).

Tolerances: the update arithmetic is the same fp32 sequence of ops on
both sides, so weights, master weights and every state slot agree to
fp32 rounding (``F32``: a few ulp, where a clip's norm or a scheduler's
float passes through a different summation order). Lamb's trust ratio
divides two norms whose sums run in other orders: ``LAMB``. A bf16
weight is its master's rounding; two masters an ulp apart may round to
neighbouring bf16 values, so bf16 weights are held to one bf16 ulp
(``BF16``). Lamb is held to the eager reference path, not the fused
one, whose own parity fails in the reference
(``tests/test_fusion.py::test_fused_optimizer_bitwise_identical``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.models import gpt as JG
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu import amp as jamp
from paddle_tpu import regularizer as jreg
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

F32 = dict(rtol=4e-6, atol=1e-7)
LAMB = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=1e-6)
SHAPES = [(6, 5), (7,), (3, 2, 4)]
STEPS = 5

#: (reference class, port class, keyword arguments) of every family
FAMILIES = {
    "sgd": ("SGD", dict(weight_decay=0.01)),
    "momentum": ("Momentum", dict(momentum=0.9, weight_decay=0.01)),
    "nesterov": ("Momentum", dict(momentum=0.9, use_nesterov=True)),
    "adam": ("Adam", dict(weight_decay=0.01)),
    "adamw": ("AdamW", dict(weight_decay=0.05)),
    "adamax": ("Adamax", dict(weight_decay=0.01)),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.02)),
    "rmsprop": ("RMSProp", dict(momentum=0.5, weight_decay=0.01)),
    "rmsprop_centered": ("RMSProp", dict(centered=True, momentum=0.3)),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
}
#: families whose constructor takes multi_precision
MULTI_PRECISION = {"SGD", "Momentum", "Adam", "AdamW", "Adamax", "Lamb"}
CLIPS = {
    "none": None,
    "value": ("ClipGradByValue", (0.5,)),
    "norm": ("ClipGradByNorm", (0.8,)),
    "global_norm": ("ClipGradByGlobalNorm", (1.0,)),
}


def _np(t):
    return np.array(jnp.asarray(t._value if hasattr(t, "_value") else t,
                                jnp.float32))


def _params(dtype, seed=0, shapes=SHAPES):
    """The reference's parameters (auto-named) and the port's, holding
    the same values in ``dtype``."""
    rng = np.random.RandomState(seed)
    vals = [(0.5 * rng.randn(*s)).astype(np.float32) for s in shapes]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = [JParameter(jnp.asarray(v, jdt)) for v in vals]
    tp = [torch.nn.Parameter(torch.from_numpy(v).to(tdt)) for v in vals]
    return jp, tp


def _grads(seed, shapes=SHAPES, steps=STEPS):
    rng = np.random.RandomState(100 + seed)
    return [[rng.randn(*s).astype(np.float32) for s in shapes]
            for _ in range(steps)]


def _set_grads(jp, tp, gs):
    for p, t, g in zip(jp, tp, gs):
        if g is None:
            p._grad_value, t.grad = None, None
            continue
        p._grad_value = jnp.asarray(g, p._value.dtype)
        t.grad = torch.from_numpy(g).to(t.dtype)


def _clip(spec):
    if spec is None:
        return None, None
    name, args = spec
    return (getattr(jopt, name)(*args), getattr(topt, name)(*args))


def _opts(family, jp, tp, lr=(0.01, 0.01), clip=(None, None),
          multi_precision=False, **extra):
    cls, kw = FAMILIES[family]
    kw = dict(kw, **extra)
    if multi_precision and cls in MULTI_PRECISION:
        kw["multi_precision"] = True
    jo = getattr(jopt, cls)(learning_rate=lr[0], parameters=jp,
                            grad_clip=clip[0], **kw)
    to = getattr(topt, cls)(learning_rate=lr[1], parameters=tp,
                            grad_clip=clip[1], **kw)
    return jo, to


def _assert_match(jo, to, jp, tp, family, dtype, msg=""):
    tol = LAMB if family == "lamb" else F32
    for i, (p, t) in enumerate(zip(jp, tp)):
        js = jo._accumulators.get(id(p))
        ts = to.state.get(to._names[i])
        assert (js is None) == (ts is None), (msg, i)
        if js is not None:
            assert set(js) == set(ts), (msg, i)
            for k in js:
                np.testing.assert_allclose(ts[k].numpy(), _np(js[k]),
                                           err_msg=f"{msg} {i} {k}", **tol)
        got = t.detach().float().numpy()
        if dtype == "bf16":
            np.testing.assert_allclose(got, _np(p), err_msg=f"{msg} {i}",
                                       **BF16)
            if ts is not None and "master" in ts:
                assert torch.equal(t.detach(), ts["master"].to(t.dtype))
        else:
            np.testing.assert_allclose(got, _np(p), err_msg=f"{msg} {i}",
                                       **tol)


def _drive(jo, to, jp, tp, grads, after_step=None):
    for k, gs in enumerate(grads):
        _set_grads(jp, tp, gs)
        jo.step()
        to.step()
        if after_step is not None:
            after_step(k)


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_steps_match_reference(family, dtype, clip):
    """Five steps of every family, fp32 and bf16 (with fp32 master
    weights where the family takes ``multi_precision``), with no clip
    and with each clip class."""
    jp, tp = _params(dtype, seed=1)
    jo, to = _opts(family, jp, tp, clip=_clip(CLIPS[clip]),
                   multi_precision=dtype == "bf16")
    _drive(jo, to, jp, tp, _grads(1))
    _assert_match(jo, to, jp, tp, family, dtype, f"{family}/{dtype}/{clip}")
    assert to.step_count == jo._step_count == STEPS


def _schedulers():
    """Every scheduler of ``lr.py``: name -> factory(module)."""
    return {
        "LRScheduler_Noam": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
        "Piecewise": lambda m: m.PiecewiseDecay([5, 20, 40],
                                                [0.1, 0.05, 0.01, 0.001]),
        "NaturalExp": lambda m: m.NaturalExpDecay(0.1, 0.05),
        "Exponential": lambda m: m.ExponentialDecay(0.1, 0.93),
        "InverseTime": lambda m: m.InverseTimeDecay(0.1, 0.2),
        "Polynomial": lambda m: m.PolynomialDecay(0.1, 25, power=2.0),
        "PolynomialCycle": lambda m: m.PolynomialDecay(0.1, 12, cycle=True),
        "LinearWarmupCosine": lambda m: m.LinearWarmup(
            m.CosineAnnealingDecay(0.1, T_max=30, eta_min=0.001), 8, 0.0,
            0.1),
        "LinearWarmupFloat": lambda m: m.LinearWarmup(0.05, 10, 0.0, 0.05),
        "CosineAnnealing": lambda m: m.CosineAnnealingDecay(0.1, 17),
        "MultiStep": lambda m: m.MultiStepDecay(0.1, [7, 19, 33], 0.5),
        "Step": lambda m: m.StepDecay(0.1, 9, 0.7),
        "Lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.97 ** e),
        "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
            0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-4),
        "OneCycle": lambda m: m.OneCycleLR(0.1, 50, phase_pct=0.3),
        "WarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
            0.1, 7, T_mult=2, eta_min=0.002),
    }


def _metric(k):
    """A plateauing metric sequence for ``ReduceOnPlateau``."""
    return 1.0 / (1 + k) if k < 12 else 0.08 + 0.001 * (k % 3)


@pytest.mark.parametrize("name", sorted(_schedulers()))
def test_scheduler_sequences_equal_reference(name):
    """60 steps of ``get_lr`` (``scheduler()``) equal exactly, and so do
    the state dicts after them."""
    make = _schedulers()[name]
    js, ts = make(jlr), make(tlr)
    got, want = [], []
    for k in range(60):
        want.append(js())
        got.append(ts())
        if name == "ReduceOnPlateau":
            js.step(_metric(k))
            ts.step(_metric(k))
        else:
            js.step()
            ts.step()
    assert got == want
    assert ts.state_dict() == js.state_dict()
    if name == "ReduceOnPlateau":
        assert min(got) < got[0]       # the plateau cut the rate


def test_fifteen_schedulers_are_exported():
    names = {"LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
             "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
             "LinearWarmup", "CosineAnnealingDecay", "MultiStepDecay",
             "StepDecay", "LambdaDecay", "ReduceOnPlateau", "OneCycleLR",
             "CosineAnnealingWarmRestarts"}
    assert all(issubclass(getattr(tlr, n), tlr.LRScheduler) for n in names)


@pytest.mark.parametrize("name", sorted(_schedulers()))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_steps_under_scheduler_match_reference(family, name):
    """An optimizer driven by a scheduler reads its rate once a step:
    the same updates as the reference's; ``set_lr`` raises."""
    make = _schedulers()[name]
    js, ts = make(jlr), make(tlr)
    jp, tp = _params("fp32", seed=2)
    jo, to = _opts(family, jp, tp, lr=(js, ts),
                   clip=_clip(CLIPS["global_norm"]))

    def advance(_):
        js.step()
        ts.step()
        assert to.get_lr() == jo.get_lr()

    _drive(jo, to, jp, tp, _grads(2), advance)
    _assert_match(jo, to, jp, tp, family, "fp32", name)
    with pytest.raises(RuntimeError):
        to.set_lr(0.1)


def test_set_lr_and_get_lr_without_scheduler():
    _, tp = _params("fp32")
    to = topt.SGD(learning_rate=0.1, parameters=tp)
    assert to.get_lr() == 0.1
    to.set_lr(0.02)
    assert to.get_lr() == 0.02


@pytest.mark.parametrize("family", ["adamw", "lamb", "sgd"])
def test_decay_filter_lr_factor_trainable_and_need_clip(family):
    """``apply_decay_param_fun`` (AdamW) / ``exclude_from_weight_decay_fn``
    (Lamb) / an ``L2Decay`` object (SGD), a per-parameter
    ``optimize_attr`` learning rate, a parameter with ``trainable =
    False`` and one with ``need_clip = False``, as attributes on the
    port's parameters and the reference's."""
    jp, tp = _params("fp32", seed=3, shapes=SHAPES + [(4,)])
    names = [p.name for p in jp]
    extra = {}
    if family == "adamw":
        extra["apply_decay_param_fun"] = lambda n: n != names[1]
    elif family == "lamb":
        extra["exclude_from_weight_decay_fn"] = \
            lambda p: p is jp[1] or p is tp[1]
    cls, kw = FAMILIES[family]
    jkw, tkw = dict(kw, **extra), dict(kw, **extra)
    if family == "sgd":
        jkw["weight_decay"] = jreg.L2Decay(0.03)
        tkw["weight_decay"] = treg.L2Decay(0.03)
    jo = getattr(jopt, cls)(
        learning_rate=0.01, grad_clip=jopt.ClipGradByGlobalNorm(0.5),
        parameters=jp, **jkw)
    to = getattr(topt, cls)(
        learning_rate=0.01, grad_clip=topt.ClipGradByGlobalNorm(0.5),
        parameters=list(zip(names, tp)), **tkw)
    for ps in (jp, tp):
        ps[0].optimize_attr = {"learning_rate": 0.5}
        ps[2].trainable = False
        ps[3].need_clip = False
    w2 = tp[2].detach().clone()
    _drive(jo, to, jp, tp, _grads(3, shapes=SHAPES + [(4,)]))
    _assert_match(jo, to, jp, tp, family, "fp32", family)
    assert torch.equal(tp[2].detach(), w2)            # not trainable
    assert names[2] not in to.state


def test_parameter_without_gradient_is_skipped():
    jp, tp = _params("fp32", seed=4)
    jo, to = _opts("adamw", jp, tp)
    w1 = tp[1].detach().clone()
    for gs in _grads(4):
        gs[1] = None
        _set_grads(jp, tp, gs)
        jo.step()
        to.step()
    assert torch.equal(tp[1].detach(), w1) and to._names[1] not in to.state
    _assert_match(jo, to, jp, tp, "adamw", "fp32")


def test_adamw_takes_the_reference_signature():
    """``learning_rate`` first: a parameter list in its place is refused
    rather than read as a rate; ``named_parameters=`` still works;
    ``lr_ratio`` and ``lazy_mode`` are accepted and ignored."""
    _, tp = _params("fp32")
    with pytest.raises(TypeError):
        topt.AdamW([("a", tp[0])])
    with pytest.raises(ValueError):
        topt.AdamW(1e-3)
    o = topt.AdamW(1e-3, 0.9, 0.99, 1e-8, tp, 0.01, lr_ratio=None,
                   lazy_mode=True)
    assert o._parameter_list == tp and o._beta2 == 0.99
    o2 = topt.AdamW(1e-3, named_parameters=[("w", tp[0])])
    assert o2._names == ["w"]


def test_adamw_groups_by_rate_and_decay_not_by_parameter(monkeypatch):
    """A decay filter and an ``optimize_attr`` rate split the step's
    parameters into groups of one rate and one decay: three groups here,
    one ``adamw_update_`` call each, however many parameters."""
    from paddle_tpu_torch.optimizer import adamw as A
    shapes = [(3,)] * 9
    _, tp = _params("fp32", seed=5, shapes=shapes)
    names = [f"w{i}" for i in range(9)]
    for p in tp[6:]:
        p.optimize_attr = {"learning_rate": 0.1}
    o = topt.AdamW(1e-3, parameters=list(zip(names, tp)),
                   apply_decay_param_fun=lambda n: n not in ("w0", "w1"))
    calls = []
    real = A.adamw_update_

    def spy(ps, *a, **k):
        calls.append((len(ps), k["lr"], k["weight_decay"]))
        return real(ps, *a, **k)

    monkeypatch.setattr(A, "adamw_update_", spy)
    for p in tp:
        p.grad = torch.ones(3)
    o.step()
    assert sorted(calls) == sorted([(2, 1e-3, 0.0), (4, 1e-3, 0.01),
                                    (3, 1e-3 * 0.1, 0.01)])


def _port_opt(family, tp, lr, multi_precision):
    cls, kw = FAMILIES[family]
    if multi_precision and cls in MULTI_PRECISION:
        kw = dict(kw, multi_precision=True)
    return getattr(topt, cls)(learning_rate=lr, parameters=tp, **kw)


def _port_steps(opt, sched, tp, grads):
    for gs in grads:
        for t, g in zip(tp, gs):
            t.grad = torch.from_numpy(g).to(t.dtype)
        opt.step()
        sched.step()


def _sched():
    return tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.01, 10), 2, 0.0,
                            0.01)


@pytest.mark.parametrize("family", ["adamw", "adam", "lamb", "rmsprop",
                                    "momentum"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_state_dict_round_trip_resumes_bitwise(family, dtype):
    """Three steps, ``state_dict`` copied through host memory (numpy)
    into a fresh optimizer and scheduler over fresh parameters: two more
    steps give the same bits as the uninterrupted run."""
    grads = _grads(6)
    mp = dtype == "bf16"
    _, tp = _params(dtype, seed=6)
    sched = _sched()
    to = _port_opt(family, tp, sched, mp)
    _port_steps(to, sched, tp, grads[:3])
    saved = {k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
             for k, v in to.state_dict().items()}
    assert saved["LR_Scheduler"] == sched.state_dict()
    fresh = [torch.nn.Parameter(p.detach().clone()) for p in tp]
    _port_steps(to, sched, tp, grads[3:])
    sched2 = _sched()
    to2 = _port_opt(family, fresh, sched2, mp)
    to2.set_state_dict(saved)
    assert to2.step_count == 3 and sched2.last_epoch == 3
    _port_steps(to2, sched2, fresh, grads[3:])
    for a, b in zip(tp, fresh):
        assert torch.equal(a.detach(), b.detach())
    for name in to._names:
        for k in to.state[name]:
            assert torch.equal(to.state[name][k], to2.state[name][k])


@pytest.mark.parametrize("family", ["adamw", "momentum", "adagrad", "lamb"])
def test_reference_state_dict_loads_through_positional_fallback(family):
    """The reference's ``state_dict`` (auto-generated ``generated_tensor_
    <n>`` names) converted to numpy loads into the port's optimizer,
    whose names differ, by position; both then step equal."""
    jp, tp = _params("fp32", seed=7)
    jo, to = _opts(family, jp, tp)
    grads = _grads(7)
    for gs in grads[:3]:
        _set_grads(jp, tp, gs)
        jo.step()
    sd = {k: (v if k == "@step" else np.asarray(v._value))
          for k, v in jo.state_dict().items()}
    assert all(k == "@step" or k.startswith("generated_tensor_")
               for k in sd)
    for p, t in zip(jp, tp):
        with torch.no_grad():
            t.copy_(torch.from_numpy(_np(p)))
    to.set_state_dict(sd)
    assert to.step_count == 3
    _drive(jo, to, jp, tp, grads[3:])
    _assert_match(jo, to, jp, tp, family, "fp32", "positional")


def test_regularizers_carry_their_coefficient():
    for cls in ("L1Decay", "L2Decay"):
        t, j = getattr(treg, cls)(0.25), getattr(jreg, cls)(0.25)
        assert t.coeff == j.coeff == t._regularization_coeff == 0.25
        assert repr(t) == repr(j)
    assert topt.Optimizer._parse_wd(treg.L1Decay(0.5)) == 0.5


# ---------------------------------------------------------------------------
# the training recipe on a tiny GPT
# ---------------------------------------------------------------------------

def _no_decay(name):
    """Decay off for biases and norms (the recipe's filter)."""
    return not any(k in name for k in ("bias", "ln_", "norm"))


def test_tiny_gpt_recipe_matches_reference():
    """Five steps of a tiny GPT (fp32) with the recipe of the chip smoke's
    GPT-2 XL training phase: ``amp.decorate``, AdamW under
    ``LinearWarmup(CosineAnnealingDecay)``, ``ClipGradByGlobalNorm(1.0)``
    and a decay filter, through ``GradScaler``; losses within 1e-5 and
    every weight within a small fraction of one step (the GPT parity
    bound of tests/test_torch_gpt.py) of the reference's."""
    paddle.seed(4)
    jm = JG.GPTForCausalLM(JG.gpt_tiny(num_hidden_layers=1))
    tm = TG.GPTForCausalLM(TG.gpt_tiny(num_hidden_layers=1), device="cpu")
    TG.params_from_numpy(tm, {n: np.asarray(p._value)
                              for n, p in jm.named_parameters()})
    for n, p in jm.named_parameters():
        p.name = n

    def recipe(lr_mod, opt_mod, amp_mod, model, params):
        sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(2e-3, 10),
                                    2, 0.0, 2e-3)
        opt = opt_mod.AdamW(learning_rate=sched, parameters=params,
                            grad_clip=opt_mod.ClipGradByGlobalNorm(1.0),
                            apply_decay_param_fun=_no_decay)
        model, opt = amp_mod.decorate(models=model, optimizers=opt,
                                      level="O1")
        return sched, opt, amp_mod.GradScaler(init_loss_scaling=2.0 ** 10)

    jsched, jo, jsc = recipe(jlr, jopt, jamp, jm, jm.parameters())
    tsched, to, tsc = recipe(tlr, topt, tamp, tm, tm.named_parameters())
    ids = np.random.RandomState(5).randint(0, 128, (2, 8)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    labels[:, -1] = -100
    for i in range(STEPS):
        jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        jsc.scale(jl).backward()
        jsc.step(jo)
        jsc.update()
        jo.clear_grad()
        jsched.step()
        tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
        tsc.scale(tl).backward()
        tsc.step(to)
        tsc.update()
        to.clear_grad()
        tsched.step()
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=1e-5, atol=1e-6, err_msg=str(i))
    assert tsc.get_loss_scaling() == jsc.get_loss_scaling()
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        want = _np(jparams[name])
        if name.startswith("gpt.decoder.qkv_biases"):
            # the key bias's gradient is rounding noise (true value 0)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=2 * 2e-3 * STEPS, err_msg=name)
            continue
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                                   atol=2e-6, err_msg=name)
