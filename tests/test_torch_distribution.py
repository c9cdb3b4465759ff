"""``paddle_tpu_torch.distribution`` against ``paddle_tpu.distribution``
on the CPU.

Draws: under the same seed each family's ``sample`` in both packages
(the port's key stream and ``jax.random``'s algorithm against
``jax.random`` itself). Discrete draws (Bernoulli, Categorical, Poisson
with Knuth's and Hörmann's samplers, Geometric, Binomial with inversion
and BTRS, Multinomial) must be equal bit for bit; continuous draws must
be within ``testing.DRAW_TOL`` (``normal``: the normal draw's 1e-6;
``gamma``: the Marsaglia-Tsang family's stated bound). A rejection
sampler may flip an accept decision on an ulp of its inputs, which
gives an unrelated value: every element beyond the bound is counted as
such a flip, and the count must not exceed ``FLIPS`` (measured: 0 in
every family at these sizes).

Closed forms: ``log_prob``, ``prob``, ``entropy``, ``mean`` and
``variance`` of every family, every transform's ``forward``,
``inverse`` and log-det-Jacobians, ``TransformedDistribution`` and every
KL pair, on the same values, at rtol 1e-5, atol 1e-5 (the reference
tests' 1e-4/1e-5 bounds, at the tighter)."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import DRAW_TOL, one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
#: Poisson's entropy below rate 16 is a series of 64 fp32 terms of up to
#: ~1.5, summed in another order on each side and through another
#: lgamma (measured 2.9e-5 relative; the reference's test: 2e-3 absolute)
POISSON_ENTROPY_TOL = dict(rtol=1e-4, atol=1e-4)
#: most draws of a family allowed beyond the bound (flipped decisions)
FLIPS = 0


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    v = t._value if hasattr(t, "_value") else t
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


R = np.random.RandomState(0)
P3 = R.uniform(0.1, 0.9, 3).astype(np.float32)
A3 = R.uniform(0.3, 4.0, 3).astype(np.float32)
B3 = R.uniform(0.3, 4.0, 3).astype(np.float32)
LOC = R.randn(3).astype(np.float32)
SCALE = R.uniform(0.5, 2.0, 3).astype(np.float32)
LOGITS = R.randn(2, 5).astype(np.float32)
RATE = np.array([0.0, 0.7, 3.5, 9.9, 10.0, 25.0], np.float32)
COUNT = np.array([0.0, 5.0, 40.0, 100.0, 200.0, 7.0], np.float32)
PROB = np.array([0.3, 0.9, 0.05, 0.6, 0.45, 0.5], np.float32)
COV = (lambda m: (m @ m.T + 3 * np.eye(3)).astype(np.float32))(
    R.randn(3, 3))
CONC = R.uniform(0.3, 3.0, (2, 4)).astype(np.float32)

#: name -> (constructor over a package's distribution module and a
#: to_tensor, kind, sample shape)
FAMILIES = {
    "Normal": (lambda D, t: D.Normal(t(LOC), t(SCALE)), "normal", (500,)),
    "Uniform": (lambda D, t: D.Uniform(t(LOC), t(LOC + SCALE)), "normal",
                (500,)),
    "Bernoulli": (lambda D, t: D.Bernoulli(t(P3)), "discrete", (500,)),
    "Categorical": (lambda D, t: D.Categorical(t(LOGITS)), "discrete",
                    (300,)),
    "Exponential": (lambda D, t: D.Exponential(t(A3)), "normal", (500,)),
    "Gamma": (lambda D, t: D.Gamma(t(A3), t(B3)), "gamma", (500,)),
    "Chi2": (lambda D, t: D.Chi2(t(A3 * 2)), "gamma", (500,)),
    "Beta": (lambda D, t: D.Beta(t(A3), t(B3)), "gamma", (500,)),
    "Dirichlet": (lambda D, t: D.Dirichlet(t(CONC)), "gamma", (200,)),
    "Laplace": (lambda D, t: D.Laplace(t(LOC), t(SCALE)), "normal", (500,)),
    "LogNormal": (lambda D, t: D.LogNormal(t(LOC), t(SCALE)), "normal",
                  (500,)),
    "Gumbel": (lambda D, t: D.Gumbel(t(LOC), t(SCALE)), "normal", (500,)),
    "Cauchy": (lambda D, t: D.Cauchy(t(LOC), t(SCALE)), "normal", (500,)),
    "StudentT": (lambda D, t: D.StudentT(t(A3 * 3), t(LOC), t(SCALE)),
                 "gamma", (500,)),
    "Poisson": (lambda D, t: D.Poisson(t(RATE)), "discrete", (400,)),
    "Geometric": (lambda D, t: D.Geometric(t(P3)), "discrete", (500,)),
    "Binomial": (lambda D, t: D.Binomial(t(COUNT), t(PROB)), "discrete",
                 (400,)),
    "Multinomial": (lambda D, t: D.Multinomial(12, t(np.exp(LOGITS[0])
                                                   / np.exp(LOGITS[0]).sum())),
                    "discrete", (100,)),
    "MultivariateNormal": (lambda D, t: D.MultivariateNormal(
        t(LOC), covariance_matrix=t(COV)), "normal", (300,)),
}


def _make(pkg, name):
    return FAMILIES[name][0](pkg.distribution, pkg.to_tensor)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_draws_are_the_references(name):
    _, kind, shape = FAMILIES[name]
    out = []
    for pkg in (J, TP):
        pkg.seed(11)
        d = _make(pkg, name)
        a = _np(d.sample(shape))
        b = _np(d.sample((2,) + shape[1:] if len(shape) > 1 else (7,)))
        out.append((a, b))
    for want, got in zip(*out):
        assert got.shape == want.shape, (got.shape, want.shape)
        if kind == "discrete":
            flips = int((got != want).sum())
        else:
            rtol, atol = DRAW_TOL[kind]
            flips = int((~np.isclose(got, want, rtol=rtol, atol=atol)).sum())
        assert flips <= FLIPS, f"{name}: {flips} of {want.size} draws differ"


@pytest.mark.parametrize("name", ["Normal", "Gamma", "Beta", "StudentT",
                                  "Dirichlet", "LogNormal"])
def test_rsample_is_sample(name):
    out = []
    for pkg in (J, TP):
        pkg.seed(5)
        out.append(_np(_make(pkg, name).rsample((50,))))
    kind = FAMILIES[name][1]
    np.testing.assert_allclose(out[1], out[0], rtol=DRAW_TOL[kind][0],
                               atol=DRAW_TOL[kind][1])


def _support(name):
    R = np.random.RandomState(len(name))
    if name in ("Bernoulli",):
        return np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    if name == "Categorical":
        return np.array([0, 4], np.int32)
    if name in ("Poisson",):
        return np.array([[0, 1, 3, 9, 12, 20]], np.float32)
    if name == "Geometric":
        return np.array([[0, 2, 5]], np.float32)
    if name == "Binomial":
        return np.array([[0, 2, 10, 50, 90, 3]], np.float32)
    if name == "Multinomial":
        return np.array([[3, 2, 4, 1, 2], [0, 0, 12, 0, 0]], np.float32)
    if name in ("Gamma", "Chi2", "Exponential", "LogNormal"):
        return R.uniform(0.1, 4.0, (4, 3)).astype(np.float32)
    if name == "Beta":
        return R.uniform(0.05, 0.95, (4, 3)).astype(np.float32)
    if name == "Dirichlet":
        x = R.uniform(0.1, 1.0, (3, 2, 4)).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    if name == "MultivariateNormal":
        return R.randn(3).astype(np.float32)    # the reference: one vector
    if name == "Uniform":
        return (LOC + SCALE * np.array([[0.1], [0.5], [0.99], [1.5]])).astype(
            np.float32)
    return R.randn(4, 3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_closed_forms_match_the_reference(name):
    out = []
    for pkg in (J, TP):
        d = _make(pkg, name)
        v = pkg.to_tensor(_support(name))
        res = {"log_prob": _np(d.log_prob(v)), "prob": _np(d.prob(v))}
        for attr in ("entropy",):
            try:
                res[attr] = _np(getattr(d, attr)())
            except NotImplementedError:
                res[attr] = None
        for attr in ("mean", "variance"):
            if hasattr(type(d), attr):
                res[attr] = _np(getattr(d, attr))
        out.append(res)
    ref, got = out
    assert set(got) == set(ref)
    for k in ref:
        if ref[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].shape == ref[k].shape, k
        tol = POISSON_ENTROPY_TOL if (name, k) == ("Poisson", "entropy") \
            else TOL
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


def test_poisson_entropy_small_and_large_rates():
    rates = np.array([0.05, 0.5, 3.0, 15.9, 16.0, 80.0], np.float32)
    out = [_np(pkg.distribution.Poisson(pkg.to_tensor(rates)).entropy())
           for pkg in (J, TP)]
    np.testing.assert_allclose(out[1], out[0], **POISSON_ENTROPY_TOL)


def _transforms(D, t):
    return {
        "affine": D.AffineTransform(t(LOC), t(SCALE)),
        "exp": D.ExpTransform(),
        "sigmoid": D.SigmoidTransform(),
        "tanh": D.TanhTransform(),
        "power": D.PowerTransform(t(np.float32(1.7))),
        "abs": D.AbsTransform(),
        "chain": D.ChainTransform([D.AffineTransform(t(np.float32(0.3)),
                                                     t(np.float32(2.0))),
                                   D.TanhTransform()]),
        "independent": D.IndependentTransform(
            D.AffineTransform(t(np.float32(0.0)), t(SCALE)), 1),
        "stack": D.StackTransform([D.ExpTransform(), D.TanhTransform(),
                                   D.AffineTransform(t(np.float32(1.0)),
                                                     t(np.float32(3.0)))],
                                  axis=1),
    }


@pytest.mark.parametrize("name", ["affine", "exp", "sigmoid", "tanh",
                                  "power", "abs", "chain", "independent",
                                  "stack"])
def test_transforms_match_the_reference(name):
    x = R.uniform(0.1, 0.9, (4, 3)).astype(np.float32)
    out = []
    for pkg in (J, TP):
        tr = _transforms(pkg.distribution, pkg.to_tensor)[name]
        t = pkg.to_tensor(x)
        y = tr.forward(t)
        out.append([_np(y), _np(tr.inverse(y)),
                    _np(tr.forward_log_det_jacobian(t)),
                    _np(tr.inverse_log_det_jacobian(y))])
    for r, g in zip(*out):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("base", ["Normal", "Dirichlet"])
def test_transformed_distribution(base):
    out = []
    for pkg in (J, TP):
        D = pkg.distribution
        pkg.seed(3)
        b = _make(pkg, base)
        trs = ([D.AffineTransform(pkg.to_tensor(np.float32(0.5)),
                                  pkg.to_tensor(np.float32(2.0))),
                D.ExpTransform()] if base == "Normal"
               else [D.AffineTransform(pkg.to_tensor(np.float32(0.0)),
                                       pkg.to_tensor(np.float32(2.0)))])
        td = D.TransformedDistribution(b, trs)
        s = td.sample((6,))
        out.append([_np(s), _np(td.log_prob(s)), _np(td.rsample((2,)))])
    for r, g in zip(*out):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


KL_PAIRS = {
    "Normal": lambda D, t: (D.Normal(t(LOC), t(SCALE)),
                            D.Normal(t(LOC[::-1].copy()), t(SCALE * 1.5))),
    "Categorical": lambda D, t: (D.Categorical(t(LOGITS)),
                                 D.Categorical(t(LOGITS[::-1].copy()))),
    "Exponential": lambda D, t: (D.Exponential(t(A3)), D.Exponential(t(B3))),
    "Gamma": lambda D, t: (D.Gamma(t(A3), t(B3)), D.Gamma(t(B3), t(A3))),
    "Chi2_Gamma": lambda D, t: (D.Chi2(t(A3 * 2)), D.Gamma(t(B3), t(A3))),
    "Beta": lambda D, t: (D.Beta(t(A3), t(B3)), D.Beta(t(B3), t(A3))),
    "Dirichlet": lambda D, t: (D.Dirichlet(t(CONC)),
                               D.Dirichlet(t(CONC[::-1].copy()))),
    "Laplace": lambda D, t: (D.Laplace(t(LOC), t(SCALE)),
                             D.Laplace(t(LOC * 2), t(SCALE[::-1].copy()))),
}


@pytest.mark.parametrize("pair", sorted(KL_PAIRS))
def test_kl_divergence_matches_the_reference(pair):
    out = []
    for pkg in (J, TP):
        p, q = KL_PAIRS[pair](pkg.distribution, pkg.to_tensor)
        out.append(_np(pkg.distribution.kl_divergence(p, q)))
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_kl_of_an_unregistered_pair_raises():
    D = TP.distribution
    with pytest.raises(NotImplementedError):
        D.kl_divergence(D.Normal(0.0, 1.0), D.Laplace(0.0, 1.0))


def test_int_parameters_become_float():
    out = [_np(pkg.distribution.Chi2(pkg.to_tensor(np.array(4, np.int32)))
               .entropy()) for pkg in (J, TP)]
    np.testing.assert_allclose(out[1], out[0], **TOL)
