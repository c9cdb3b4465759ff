"""The distribution zoo beyond the first four — counterpart of
``paddle_tpu/distribution/extras.py``.

Sampling follows ``jax.random``'s algorithm for each family over the
framework key stream (``paddle_tpu_torch.random``: Marsaglia and Tsang's
gamma loop with its key splits, Knuth's and Hörmann's Poisson samplers,
inversion and BTRS for the binomial), so a seed gives the reference's
draws; ``log_prob`` and ``entropy`` are the closed forms.
"""

from __future__ import annotations

import math

import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor
from .. import random as _random
from . import Distribution, _bshape, _params, _t, _val

__all__ = [
    "Exponential", "Gamma", "Beta", "Dirichlet", "Laplace", "LogNormal",
    "Gumbel", "Cauchy", "Chi2", "StudentT", "Poisson", "Geometric",
    "Binomial", "Multinomial", "MultivariateNormal", "ExponentialFamily",
]

_lgamma = torch.lgamma
_digamma = torch.digamma


def _betaln(a, b):
    return _lgamma(a) + _lgamma(b) - _lgamma(a + b)


class ExponentialFamily(Distribution):
    """Marker base of the reference's ExponentialFamily (every subclass
    has a closed-form entropy, so its Bregman shortcut is not needed)."""


class Exponential(ExponentialFamily):
    def __init__(self, rate, name=None):
        (self.rate,) = _params(rate)

    @property
    def mean(self):
        return Tensor(1.0 / self.rate)

    @property
    def variance(self):
        return Tensor(1.0 / self.rate ** 2)

    def sample(self, shape=()):
        key = _random.next_key()
        e = _random.exponential_draw(key, tuple(shape) + tuple(self.rate.shape),
                                     self.rate.device)
        return Tensor(e / self.rate)

    rsample = sample

    def log_prob(self, value):
        return apply(lambda v: torch.log(self.rate) - self.rate * v,
                     _t(value), op_name="exponential_log_prob")

    def entropy(self):
        return Tensor(1.0 - torch.log(self.rate))


class Gamma(ExponentialFamily):
    def __init__(self, concentration, rate, name=None):
        self.concentration, self.rate = _params(concentration, rate)

    @property
    def mean(self):
        return Tensor(self.concentration / self.rate)

    @property
    def variance(self):
        return Tensor(self.concentration / self.rate ** 2)

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.concentration, self.rate)
        g = _random.gamma_draw(key, self.concentration.expand(base),
                               tuple(shape) + base)
        return Tensor(g / self.rate)

    rsample = sample

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return apply(
            lambda v: a * torch.log(b) + (a - 1) * torch.log(v) - b * v
            - _lgamma(a), _t(value), op_name="gamma_log_prob")

    def entropy(self):
        a = self.concentration
        return Tensor(a - torch.log(self.rate) + _lgamma(a)
                      + (1 - a) * _digamma(a))


class Chi2(Gamma):
    def __init__(self, df, name=None):
        df = _val(df).float()
        super().__init__(Tensor(df / 2.0), Tensor(torch.full_like(df, 0.5)))
        self.df = df


class Beta(ExponentialFamily):
    def __init__(self, alpha, beta, name=None):
        self.alpha, self.beta = _params(alpha, beta)

    @property
    def mean(self):
        return Tensor(self.alpha / (self.alpha + self.beta))

    @property
    def variance(self):
        s = self.alpha + self.beta
        return Tensor(self.alpha * self.beta / (s * s * (s + 1)))

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.alpha, self.beta)
        return Tensor(_random.beta_draw(key, self.alpha.expand(base),
                                        self.beta.expand(base),
                                        tuple(shape) + base))

    rsample = sample

    def log_prob(self, value):
        a, b = self.alpha, self.beta
        lbeta = _betaln(a, b)
        return apply(
            lambda v: (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
            - lbeta, _t(value), op_name="beta_log_prob")

    def entropy(self):
        a, b = self.alpha, self.beta
        return Tensor(_betaln(a, b) - (a - 1) * _digamma(a)
                      - (b - 1) * _digamma(b)
                      + (a + b - 2) * _digamma(a + b))


class Dirichlet(ExponentialFamily):
    def __init__(self, concentration, name=None):
        (self.concentration,) = _params(concentration)

    @property
    def mean(self):
        c = self.concentration
        return Tensor(c / c.sum(-1, keepdim=True))

    def sample(self, shape=()):
        key = _random.next_key()
        c = self.concentration
        return Tensor(_random.dirichlet_draw(key, c, tuple(shape)
                                             + tuple(c.shape[:-1])))

    rsample = sample

    def log_prob(self, value):
        c = self.concentration
        norm = torch.sum(_lgamma(c), -1) - _lgamma(c.sum(-1))
        return apply(
            lambda v: torch.sum((c - 1) * torch.log(v), -1) - norm,
            _t(value), op_name="dirichlet_log_prob")

    def entropy(self):
        c = self.concentration
        c0 = c.sum(-1)
        k = c.shape[-1]
        ln_b = torch.sum(_lgamma(c), -1) - _lgamma(c0)
        return Tensor(ln_b + (c0 - k) * _digamma(c0)
                      - torch.sum((c - 1) * _digamma(c), -1))


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    @property
    def mean(self):
        return Tensor(self.loc.expand(_bshape(self.loc, self.scale)))

    @property
    def variance(self):
        return Tensor(2.0 * self.scale ** 2)

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.loc, self.scale)
        e = _random.laplace_draw(key, tuple(shape) + base, self.loc.device)
        return Tensor(self.loc + self.scale * e)

    rsample = sample

    def log_prob(self, value):
        return apply(
            lambda v: -torch.abs(v - self.loc) / self.scale
            - torch.log(2 * self.scale), _t(value),
            op_name="laplace_log_prob")

    def entropy(self):
        return Tensor(1.0 + torch.log(2 * self.scale))


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    @property
    def mean(self):
        return Tensor(torch.exp(self.loc + self.scale ** 2 / 2))

    @property
    def variance(self):
        s2 = self.scale ** 2
        return Tensor((torch.exp(s2) - 1) * torch.exp(2 * self.loc + s2))

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.loc, self.scale)
        eps = _random.normal_draw(key, tuple(shape) + base, self.loc.device)
        return Tensor(torch.exp(self.loc + self.scale * eps))

    rsample = sample

    def log_prob(self, value):
        return apply(
            lambda v: -((torch.log(v) - self.loc) ** 2)
            / (2 * self.scale ** 2)
            - torch.log(v * self.scale) - 0.5 * math.log(2 * math.pi),
            _t(value), op_name="lognormal_log_prob")

    def entropy(self):
        return Tensor(self.loc + 0.5
                      + 0.5 * math.log(2 * math.pi) + torch.log(self.scale))


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    _EULER = 0.57721566490153286

    @property
    def mean(self):
        return Tensor(self.loc + self._EULER * self.scale)

    @property
    def variance(self):
        return Tensor((math.pi ** 2 / 6) * self.scale ** 2)

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.loc, self.scale)
        g = _random.gumbel_draw(key, tuple(shape) + base, self.loc.device)
        return Tensor(self.loc + self.scale * g)

    rsample = sample

    def log_prob(self, value):
        def fn(v):
            z = (v - self.loc) / self.scale
            return -(z + torch.exp(-z)) - torch.log(self.scale)
        return apply(fn, _t(value), op_name="gumbel_log_prob")

    def entropy(self):
        return Tensor(torch.log(self.scale) + 1.0 + self._EULER)


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.loc, self.scale)
        c = _random.cauchy_draw(key, tuple(shape) + base, self.loc.device)
        return Tensor(self.loc + self.scale * c)

    rsample = sample

    def log_prob(self, value):
        def fn(v):
            z = (v - self.loc) / self.scale
            return -torch.log1p(z * z) - torch.log(math.pi * self.scale)
        return apply(fn, _t(value), op_name="cauchy_log_prob")

    def entropy(self):
        return Tensor(torch.log(4 * math.pi * self.scale))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        self.df, self.loc, self.scale = _params(df, loc, scale)

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.df, self.loc, self.scale)
        t = _random.t_draw(key, self.df.expand(base), tuple(shape) + base)
        return Tensor(self.loc + self.scale * t)

    rsample = sample

    def log_prob(self, value):
        df = self.df

        def fn(v):
            z = (v - self.loc) / self.scale
            return (_lgamma((df + 1) / 2) - _lgamma(df / 2)
                    - 0.5 * torch.log(df * math.pi) - torch.log(self.scale)
                    - (df + 1) / 2 * torch.log1p(z * z / df))
        return apply(fn, _t(value), op_name="studentt_log_prob")

    def entropy(self):
        df = self.df
        return Tensor((df + 1) / 2 * (_digamma((df + 1) / 2)
                                      - _digamma(df / 2))
                      + 0.5 * torch.log(df) + torch.log(self.scale)
                      + _betaln(df / 2, torch.full_like(df, 0.5)))


class Poisson(ExponentialFamily):
    def __init__(self, rate, name=None):
        (self.rate,) = _params(rate)

    @property
    def mean(self):
        return Tensor(self.rate)

    variance = mean

    def sample(self, shape=()):
        key = _random.next_key()
        out = _random.poisson_draw(key, self.rate,
                                   tuple(shape) + tuple(self.rate.shape))
        return Tensor(out.float())

    def log_prob(self, value):
        return apply(
            lambda v: v * torch.log(self.rate) - self.rate
            - _lgamma(v + 1), _t(value), op_name="poisson_log_prob")

    def entropy(self):
        # the exact series, truncated, for small rates (the Stirling
        # expansion is far off there), Stirling for large ones:
        # H = r − r·log r + e^{−r}·Σ r^k·log(k!)/k!
        r = self.rate
        k = torch.arange(64, dtype=torch.float32, device=r.device)
        log_kfact = _lgamma(k + 1)
        rk = r[..., None]
        series = torch.exp(-rk + k * torch.log(torch.clamp_min(rk, 1e-30))
                           - log_kfact) * log_kfact
        exact = r - r * torch.log(torch.clamp_min(r, 1e-30)) + series.sum(-1)
        stirling = (0.5 * torch.log(2 * math.pi * math.e * r)
                    - 1 / (12 * r) - 1 / (24 * r * r))
        return Tensor(torch.where(r < 16.0, exact, stirling))


class Geometric(Distribution):
    """P(X=k) = (1-p)^k p over k = 0, 1, 2, … (failures before the first
    success, the reference's convention)."""

    def __init__(self, probs, name=None):
        (self.probs,) = _params(probs)

    @property
    def mean(self):
        return Tensor((1 - self.probs) / self.probs)

    @property
    def variance(self):
        return Tensor((1 - self.probs) / self.probs ** 2)

    def sample(self, shape=()):
        key = _random.next_key()
        out = _random.geometric_draw(key, self.probs,
                                     tuple(shape) + tuple(self.probs.shape))
        # jax.random.geometric counts trials (1-based): shift to failures
        return Tensor(out - 1.0)

    def log_prob(self, value):
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return apply(lambda v: v * torch.log1p(-p) + torch.log(p),
                     _t(value), op_name="geometric_log_prob")

    def entropy(self):
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        q = 1 - p
        return Tensor(-(q * torch.log(q) + p * torch.log(p)) / p)


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count, self.probs = _params(total_count, probs)

    @property
    def mean(self):
        return Tensor(self.total_count * self.probs)

    @property
    def variance(self):
        return Tensor(self.total_count * self.probs * (1 - self.probs))

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.total_count, self.probs)
        return Tensor(_random.binomial_draw(key, self.total_count, self.probs,
                                           tuple(shape) + base))

    def log_prob(self, value):
        n, p = self.total_count, torch.clamp(self.probs, 1e-7, 1 - 1e-7)

        def fn(v):
            return (_lgamma(n + 1) - _lgamma(v + 1) - _lgamma(n - v + 1)
                    + v * torch.log(p) + (n - v) * torch.log1p(-p))
        return apply(fn, _t(value), op_name="binomial_log_prob")


class Multinomial(Distribution):
    """Counts over k categories from ``total_count`` draws (a Python
    int): ``total_count`` categorical draws under the split keys, summed
    as one-hots, as the reference's scan does."""

    def __init__(self, total_count: int, probs, name=None):
        self.total_count = int(total_count)
        (self.probs,) = _params(probs)

    @property
    def mean(self):
        return Tensor(self.total_count * self.probs)

    def sample(self, shape=()):
        from ..inference import prng
        key = _random.next_key().to(self.probs.device)
        k = self.probs.shape[-1]
        logits = torch.log(torch.clamp_min(self.probs, 1e-30))
        batch = tuple(shape) + tuple(self.probs.shape[:-1])
        counts = torch.zeros(batch + (k,), device=self.probs.device)
        for k_i in prng.split(key, self.total_count):
            draw = _random.categorical_draw(k_i, logits, batch)
            counts = counts + torch.nn.functional.one_hot(draw, k).float()
        return Tensor(counts)

    def log_prob(self, value):
        p = torch.clamp_min(self.probs, 1e-30)

        def fn(v):
            return (_lgamma(torch.sum(v, -1) + 1)
                    - torch.sum(_lgamma(v + 1), -1)
                    + torch.sum(v * torch.log(p), -1))
        return apply(fn, _t(value), op_name="multinomial_log_prob")


class MultivariateNormal(Distribution):
    def __init__(self, loc, covariance_matrix=None, scale_tril=None,
                 name=None):
        if (covariance_matrix is None) == (scale_tril is None):
            raise ValueError("give exactly one of covariance_matrix / "
                             "scale_tril")
        given = covariance_matrix if scale_tril is None else scale_tril
        self.loc, given = _params(loc, given)
        if covariance_matrix is not None:
            self.covariance_matrix = given
            self.scale_tril = torch.linalg.cholesky(given)
        else:
            self.scale_tril = given
            self.covariance_matrix = given @ given.transpose(-1, -2)

    @property
    def mean(self):
        return Tensor(self.loc)

    @property
    def variance(self):
        return Tensor(torch.diagonal(self.covariance_matrix, dim1=-2,
                                     dim2=-1))

    def sample(self, shape=()):
        key = _random.next_key()
        eps = _random.normal_draw(key, tuple(shape) + tuple(self.loc.shape),
                                  self.loc.device)
        return Tensor(self.loc + torch.einsum("...ij,...j->...i",
                                              self.scale_tril, eps))

    rsample = sample

    def log_prob(self, value):
        d = self.loc.shape[-1]
        L = self.scale_tril
        half_logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2,
                                                         dim2=-1)), -1)

        def fn(v):
            diff = v - self.loc
            sol = torch.linalg.solve_triangular(
                L, diff[..., None], upper=False)[..., 0]
            maha = torch.sum(sol * sol, -1)
            return (-0.5 * maha - half_logdet
                    - 0.5 * d * math.log(2 * math.pi))
        return apply(fn, _t(value), op_name="mvn_log_prob")

    def entropy(self):
        d = self.loc.shape[-1]
        half_logdet = torch.sum(torch.log(torch.diagonal(
            self.scale_tril, dim1=-2, dim2=-1)), -1)
        return Tensor(0.5 * d * (1 + math.log(2 * math.pi)) + half_logdet)
