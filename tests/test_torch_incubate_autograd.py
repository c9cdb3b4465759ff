"""``paddle_tpu_torch.incubate.autograd`` (over ``torch.func``) against
``paddle_tpu.incubate.autograd`` (over ``jax``) on the CPU: ``jvp`` and
``vjp`` with and without explicit vectors and over several inputs and
outputs, ``Jacobian``/``jacobian`` single, multi-input and batched,
``Hessian``/``hessian`` single and batched, each on the same seeded
numpy inputs through functions written with the Paddle-shaped ops of
each package. Bounds are the reference test's own
(``test_api_sweep5.py``): atol 1e-5, with rtol 1e-5."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    if isinstance(t, (list, tuple)):
        return [_np(x) for x in t]
    v = t._value if hasattr(t, "_value") else t
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _close(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL)


R = np.random.RandomState(0)
X = R.randn(3).astype(np.float32)
Y = R.randn(3).astype(np.float32)
V = R.randn(3).astype(np.float32)
XB = R.randn(4, 3).astype(np.float32)


def _f(pkg):
    return lambda v: pkg.tanh(v) * v * 2.0


def _f2(pkg):
    return lambda a, b: (a * b).sum() + (a * a * b).sum()


def _f_multi_out(pkg):
    return lambda a, b: (a * b, pkg.exp(a) - b)


def _run(fn):
    return [fn(pkg) for pkg in (J, TP)]


@pytest.mark.parametrize("with_v", [False, True])
def test_jvp(with_v):
    def go(pkg):
        v = pkg.to_tensor(V) if with_v else None
        out, tan = pkg.incubate.autograd.jvp(_f(pkg), pkg.to_tensor(X), v)
        return _np(out), _np(tan)
    (ro, rt), (to, tt) = _run(go)
    _close(to, ro)
    _close(tt, rt)


def test_jvp_multi_in_out():
    def go(pkg):
        xs = [pkg.to_tensor(X), pkg.to_tensor(Y)]
        out, tan = pkg.incubate.autograd.jvp(_f_multi_out(pkg), xs,
                                             [pkg.to_tensor(V),
                                              pkg.to_tensor(X)])
        return _np(out), _np(tan)
    (ro, rt), (to, tt) = _run(go)
    _close(to, ro)
    _close(tt, rt)


@pytest.mark.parametrize("with_v", [False, True])
def test_vjp(with_v):
    def go(pkg):
        v = pkg.to_tensor(V) if with_v else None
        out, g = pkg.incubate.autograd.vjp(_f(pkg), pkg.to_tensor(X), v)
        return _np(out), _np(g)
    (ro, rg), (to, tg) = _run(go)
    _close(to, ro)
    _close(tg, rg)


def test_vjp_multi_in_and_scalar_out():
    def go(pkg):
        xs = [pkg.to_tensor(X), pkg.to_tensor(Y)]
        out, g = pkg.incubate.autograd.vjp(_f2(pkg), xs)
        o2, g2 = pkg.incubate.autograd.vjp(
            _f_multi_out(pkg), xs, [pkg.to_tensor(V), pkg.to_tensor(Y)])
        return _np(out), _np(g), _np(o2), _np(g2)
    ref, got = _run(go)
    for g, w in zip(got, ref):
        _close(g, w)


@pytest.mark.parametrize("batched", [False, True])
def test_jacobian(batched):
    def go(pkg):
        x = pkg.to_tensor(XB if batched else X)
        jac = pkg.incubate.autograd.Jacobian(_f(pkg), x, is_batched=batched)
        return _np(jac[:]), list(jac.shape), _np(
            pkg.incubate.autograd.jacobian(_f(pkg), x, is_batched=batched))
    (rm, rs, rj), (tm, ts, tj) = _run(go)
    _close(tm, rm)
    _close(tj, rj)
    assert ts == rs


def test_jacobian_over_two_inputs():
    def go(pkg):
        xs = [pkg.to_tensor(X), pkg.to_tensor(Y)]
        jac = pkg.incubate.autograd.Jacobian(
            lambda a, b: a * b + pkg.sin(a), xs)
        return _np(jac[:]), [list(s) for s in jac.shape]
    (rm, rs), (tm, ts) = _run(go)
    _close(tm, rm)
    assert ts == rs


@pytest.mark.parametrize("batched", [False, True])
def test_hessian(batched):
    def go(pkg):
        x = pkg.to_tensor(XB if batched else X)
        f = lambda v: (v * v * v).sum() + (pkg.tanh(v) * v).sum()  # noqa
        h = pkg.incubate.autograd.Hessian(f, x, is_batched=batched)
        return _np(h[:]), list(h.shape), _np(
            pkg.incubate.autograd.hessian(f, x, is_batched=batched))
    (rm, rs, rh), (tm, ts, th) = _run(go)
    _close(tm, rm)
    _close(th, rh)
    assert ts == rs


def test_hessian_over_two_inputs_raises_as_the_reference():
    for pkg in (J, TP):
        h = pkg.incubate.autograd.Hessian(_f2(pkg), [pkg.to_tensor(X),
                                                    pkg.to_tensor(Y)])
        with pytest.raises(NotImplementedError):
            h[:]


def test_results_stop_gradients():
    out, tan = TP.incubate.autograd.jvp(_f(TP), TP.to_tensor(X))
    assert out.stop_gradient and tan.stop_gradient
