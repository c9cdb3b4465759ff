"""``paddle_tpu_torch.amp`` against ``paddle_tpu.amp`` on the CPU: the
``GradScaler`` state machine over a scripted run of finite and inf/nan
steps (the scale, the good and bad counts, which steps were applied and
the state dict, step by step), ``decorate`` at O1 and O2, the cast rule
``_target_dtype``, and ``auto_cast`` (a no-op context disabled; enabled,
the dispatcher's cast hook, held to the reference's per-op casts in
tests/test_torch_dispatch.py).

Weights after each step are held to fp32 rounding (``F32``): the
unscale multiplies by the same power-of-two reciprocal on both sides and
the update is the same fp32 arithmetic (tests/test_torch_optimizer.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

F32 = dict(rtol=4e-6, atol=1e-7)
SHAPES = [(5, 4), (6,)]
#: which steps carry a non-finite gradient (and which value)
SCRIPT = [None, "inf", None, None, None, None, "inf", "nan", "-inf", None,
          None, None, "inf", None]


def _params(seed=0, dtype="fp32"):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([JParameter(jnp.asarray(v, jdt)) for v in vals],
            [torch.nn.Parameter(torch.from_numpy(v).to(tdt)) for v in vals])


def _scaled_grads(k, scale, bad):
    """Step k's gradients as a scaled loss's backward gives them, with
    ``bad`` (inf, nan) planted in one element."""
    rng = np.random.RandomState(50 + k)
    gs = [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    if bad is not None:
        gs[k % 2].flat[3] = float(bad)
    return gs


def _np(v):
    return np.array(jnp.asarray(v, jnp.float32))


def _scalers(**kw):
    kw = {**dict(init_loss_scaling=2.0 ** 6, incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=3, decr_every_n_nan_or_inf=2), **kw}
    return jamp.GradScaler(**kw), tamp.GradScaler(**kw)


@pytest.mark.parametrize("family", ["SGD", "AdamW", "Momentum"])
def test_grad_scaler_state_machine_matches_reference(family):
    jp, tp = _params(1)
    jo = getattr(jopt, family)(learning_rate=0.01, parameters=jp)
    to = getattr(topt, family)(learning_rate=0.01, parameters=tp)
    js, ts = _scalers()
    for k, bad in enumerate(SCRIPT):
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        gs = _scaled_grads(k, js.get_loss_scaling(), bad)
        before = [p.detach().clone() for p in tp]
        for p, t, g in zip(jp, tp, gs):
            p._grad_value = jnp.asarray(g)
            t.grad = torch.from_numpy(g)
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
        jo.clear_grad()
        to.clear_grad()
        changed = any(not torch.equal(a, p.detach())
                      for a, p in zip(before, tp))
        assert changed == (bad is None), k
        assert ts.state_dict() == js.state_dict(), k
        for p, t in zip(jp, tp):
            np.testing.assert_allclose(t.detach().numpy(), _np(p._value),
                                       err_msg=str(k), **F32)
    assert to.step_count == jo._step_count == SCRIPT.count(None)
    assert ts.host_reads == len(SCRIPT)
    # the scale fell twice (two runs of two bad steps) and rose twice
    assert ts.get_loss_scaling() == js.get_loss_scaling()


def test_inf_step_leaves_bf16_weights_masters_and_moments_bitwise():
    """bf16 parameters, AdamW with master weights: a step whose gradient
    holds an inf changes no weight, no master and no moment, and the
    step count does not move; the scale drops after the second."""
    _, tp = _params(2, "bf16")
    to = topt.AdamW(learning_rate=0.01, parameters=tp, multi_precision=True)
    _, ts = _scalers(decr_every_n_nan_or_inf=1)
    for k, bad in enumerate([None, "inf"]):
        gs = _scaled_grads(k, ts.get_loss_scaling(), bad)
        if bad is not None:
            w = [p.detach().clone() for p in tp]
            st = {n: {s: v.clone() for s, v in d.items()}
                  for n, d in to.state.items()}
        for t, g in zip(tp, gs):
            t.grad = torch.from_numpy(g).to(torch.bfloat16)
        ts.step(to)
        to.clear_grad()
    assert all(torch.equal(a, p.detach()) for a, p in zip(w, tp))
    assert all(torch.equal(st[n][s], to.state[n][s])
               for n in st for s in st[n])
    assert to.step_count == 1 and ts.get_loss_scaling() == 2.0 ** 5


def test_unscaled_gradients_stay_beside_the_optimizer():
    """The unscaled gradients are fp32 and reach the update through
    ``_grads()`` for the step; ``.grad`` keeps the scaled bf16 values, and
    an explicit ``unscale_`` is not applied twice by ``step``."""
    _, tp = _params(3, "bf16")
    to = topt.SGD(learning_rate=0.5, parameters=tp, multi_precision=True)
    _, ts = _scalers()
    gs = _scaled_grads(0, ts.get_loss_scaling(), None)
    for t, g in zip(tp, gs):
        t.grad = torch.from_numpy(g).to(torch.bfloat16)
    grads = [t.grad.clone() for t in tp]
    ts.unscale_(to)
    assert all(u.dtype == torch.float32 for u in ts._unscaled)
    want = [p.detach().float() - 0.5 * (g.float() / ts.get_loss_scaling())
            for p, g in zip(tp, grads)]
    ts.step(to)
    assert all(torch.equal(t.grad, g) for t, g in zip(tp, grads))
    for name, w in zip(to._names, want):
        torch.testing.assert_close(to.state[name]["master"], w, rtol=1e-6,
                                   atol=1e-7)
    assert "_grads" not in vars(to) and ts.host_reads == 1


def test_disabled_scaler_passes_through():
    _, tp = _params(4)
    to = topt.SGD(learning_rate=0.1, parameters=tp)
    ts = tamp.GradScaler(enable=False)
    x = torch.ones(2)
    assert ts.scale(x) is x and not ts.is_enable()
    for t in tp:
        t.grad = torch.ones_like(t)
    ts.step(to)
    assert to.step_count == 1 and ts.host_reads == 0


def test_scaler_state_dict_round_trip():
    js, ts = _scalers()
    state = {"scale": 8.0, "good": 2, "bad": 1}
    ts.load_state_dict(dict(state))
    js.load_state_dict(dict(state))
    assert ts.state_dict() == js.state_dict() == state
    assert ts.get_loss_scaling() == 8.0


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_matches_reference(level):
    """O2 casts the model's parameters to bf16 in place (the optimizer
    keeps the same parameter objects) and turns on master weights; O1
    changes neither."""
    jnet = paddle.nn.Linear(4, 3)
    tnet = torch.nn.Linear(4, 3)
    jo = jopt.AdamW(learning_rate=0.1, parameters=jnet.parameters())
    to = topt.AdamW(learning_rate=0.1, parameters=tnet.named_parameters())
    params = list(tnet.parameters())
    jm, jo2 = jamp.decorate(models=jnet, optimizers=jo, level=level,
                            dtype="bfloat16")
    tm, to2 = tamp.decorate(models=tnet, optimizers=to, level=level,
                            dtype="bfloat16")
    assert tm is tnet and to2 is to and jm is jnet and jo2 is jo
    assert to._multi_precision == jo._multi_precision == (level == "O2")
    want = jnp.bfloat16 if level == "O2" else jnp.float32
    assert all(p._value.dtype == want for p in jnet.parameters())
    tw = torch.bfloat16 if level == "O2" else torch.float32
    assert all(p.dtype == tw for p in tnet.parameters())
    assert all(a is b for a, b in zip(params, to._parameter_list))
    models = tamp.decorate(models=[tnet], level=level)
    assert models == [tnet]


def test_target_dtype_rule_matches_reference():
    ops = sorted(tamp.WHITE_LIST | tamp.BLACK_LIST | {"add", "relu"})
    jdt = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}

    def name(dt):
        return None if dt is None else str(np.dtype(dt) if not isinstance(
            dt, torch.dtype) else dt).replace("torch.", "")
    state = tamp.amp_state()
    saved = dict(state)
    try:
        for level in ("O1", "O2"):
            with jamp.auto_cast(enable=True, level=level,
                                custom_black_list={"matmul"}):
                state.update(level=level, custom_black={"matmul"})
                for op in ops:
                    for d in ("bf16", "fp32"):
                        got = tamp._target_dtype(op, tdt[d])
                        want = jamp._target_dtype(op, jdt[d])
                        assert name(got) == name(want), (level, op, d)
    finally:
        state.update(saved)


def test_auto_cast_disabled_is_a_no_op_and_enabled_raises():
    before = dict(tamp.amp_state())
    with tamp.auto_cast(enable=False, level="O2"):
        assert tamp.amp_state()["enabled"] is False
        assert tamp.amp_state()["level"] == "O2"
    assert tamp.amp_state() == before
    # enabled it no longer raises: the port's dispatcher casts per op
    import paddle_tpu_torch as TP
    x = TP.to_tensor(np.ones((2, 2), np.float32), place=TP.CPUPlace())
    with tamp.auto_cast():
        assert tamp.amp_state()["enabled"] is True
        assert TP.matmul(x, x).dtype == torch.bfloat16
    assert tamp.amp_state() == before
    assert tamp.amp_guard is tamp.auto_cast
