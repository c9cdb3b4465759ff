"""``paddle_tpu_torch.distribution`` — probability distributions,
counterpart of ``paddle_tpu/distribution/``.

Every ``sample``/``rsample`` draws from the framework key stream
(``paddle_tpu_torch.random``) with ``jax.random``'s algorithm over the
same key, so a seed gives the reference's draws: discrete ones bit for
bit, continuous ones to the rounding of ``log``, ``erfinv`` and ``pow``
(``testing.DRAW_TOL``). ``log_prob``, ``entropy``, the moments and the
KL forms are the reference's closed forms in torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor
from .. import random as _random


def _val(x, device=None):
    """A parameter as a torch value: a Tensor's (an integer or bool one as
    fp32, which the closed forms need), else fp32 on ``device`` (the
    current place when None)."""
    if isinstance(x, Tensor):
        x = x._value
    if isinstance(x, torch.Tensor):
        v = x.detach()
        if not (v.dtype.is_floating_point or v.dtype.is_complex):
            v = v.float()
        return v
    if device is None:
        from ..core.place import current_place
        device = current_place().torch_device()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _params(*xs):
    """Several parameters on one device: that of the first given as a
    tensor (the current place when none is)."""
    dev = None
    for x in xs:
        v = x._value if isinstance(x, Tensor) else x
        if isinstance(v, torch.Tensor):
            dev = v.device
            break
    return tuple(_val(x, dev) for x in xs)


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _bshape(*vs):
    return tuple(torch.broadcast_shapes(*(v.shape for v in vs)))


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value) -> Tensor:
        raise NotImplementedError

    def prob(self, value) -> Tensor:
        return apply(torch.exp, self.log_prob(value), op_name="dist_prob")

    def entropy(self) -> Tensor:
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    @property
    def mean(self) -> Tensor:
        return Tensor(self.loc.expand(_bshape(self.loc, self.scale)))

    @property
    def variance(self) -> Tensor:
        return Tensor((self.scale ** 2).expand(_bshape(self.loc, self.scale)))

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.loc, self.scale)
        eps = _random.normal_draw(key, tuple(shape) + base, self.loc.device)
        return Tensor(self.loc + self.scale * eps)

    rsample = sample  # reparameterized by construction

    def log_prob(self, value) -> Tensor:
        def fn(v):
            var = self.scale ** 2
            return (-((v - self.loc) ** 2) / (2 * var)
                    - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))
        return apply(fn, _t(value), op_name="normal_log_prob")

    def entropy(self) -> Tensor:
        base = _bshape(self.loc, self.scale)
        return Tensor((0.5 + 0.5 * math.log(2 * math.pi)
                       + torch.log(self.scale)).expand(base))

    def kl_divergence(self, other: "Normal") -> Tensor:
        var_a, var_b = self.scale ** 2, other.scale ** 2
        return Tensor(0.5 * (var_a / var_b
                             + (self.loc - other.loc) ** 2 / var_b
                             - 1.0 + torch.log(var_b) - torch.log(var_a)))


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _params(low, high)

    def sample(self, shape=()):
        key = _random.next_key()
        base = _bshape(self.low, self.high)
        u = _random.uniform_draw(key, tuple(shape) + base,
                                 device=self.low.device)
        return Tensor(self.low + (self.high - self.low) * u)

    rsample = sample

    def log_prob(self, value) -> Tensor:
        def fn(v):
            inside = (v >= self.low) & (v < self.high)
            lp = -torch.log(self.high - self.low)
            return torch.where(inside, lp, torch.full_like(lp, -math.inf))
        return apply(fn, _t(value), op_name="uniform_log_prob")

    def entropy(self) -> Tensor:
        return Tensor(torch.log(self.high - self.low))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        (self.probs,) = _params(probs)

    def sample(self, shape=()):
        key = _random.next_key()
        out = _random.bernoulli_draw(key, self.probs,
                                     tuple(shape) + tuple(self.probs.shape),
                                     self.probs.device)
        return Tensor(out.float())

    def log_prob(self, value) -> Tensor:
        def fn(v):
            p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
            return v * torch.log(p) + (1 - v) * torch.log1p(-p)
        return apply(fn, _t(value), op_name="bernoulli_log_prob")

    def entropy(self) -> Tensor:
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return Tensor(-(p * torch.log(p) + (1 - p) * torch.log1p(-p)))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        (self.logits,) = _params(logits)

    @property
    def probs(self) -> Tensor:
        return Tensor(torch.softmax(self.logits, dim=-1))

    def sample(self, shape=()):
        key = _random.next_key().to(self.logits.device)
        out = _random.categorical_draw(
            key, self.logits, tuple(shape) + tuple(self.logits.shape[:-1]))
        return Tensor(out.to(torch.int32))

    def log_prob(self, value) -> Tensor:
        def fn(v):
            logp = torch.log_softmax(self.logits, dim=-1)
            vi = v.long()
            if logp.dim() == 1:  # shared categories, batched values
                return logp[vi]
            return torch.gather(logp, -1, vi[..., None])[..., 0]
        return apply(fn, _t(value), op_name="categorical_log_prob")

    def entropy(self) -> Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return Tensor(-torch.sum(torch.exp(logp) * logp, dim=-1))

    def kl_divergence(self, other: "Categorical") -> Tensor:
        la = torch.log_softmax(self.logits, dim=-1)
        lb = torch.log_softmax(other.logits, dim=-1)
        return Tensor(torch.sum(torch.exp(la) * (la - lb), dim=-1))


#: closed-form KLs of the extended zoo (the reference's ``_KL_REGISTRY``)
_KL_REGISTRY = {}


def register_kl(type_p, type_q):
    def deco(fn):
        _KL_REGISTRY[(type_p, type_q)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution) -> Tensor:
    # the most specific matching (super)class pair wins, as in the
    # reference, so Chi2 resolves to the (Gamma, Gamma) form
    for tp in type(p).__mro__:
        for tq in type(q).__mro__:
            fn = _KL_REGISTRY.get((tp, tq))
            if fn is not None:
                return fn(p, q)
    if type(p) is type(q) and hasattr(p, "kl_divergence"):
        return p.kl_divergence(q)
    raise NotImplementedError(
        f"kl_divergence({type(p).__name__}, {type(q).__name__})")


from .extras import (  # noqa: E402,F401
    Beta, Binomial, Cauchy, Chi2, Dirichlet, Exponential,
    ExponentialFamily, Gamma, Geometric, Gumbel, Laplace, LogNormal,
    Multinomial, MultivariateNormal, Poisson, StudentT,
)
from .transform import (  # noqa: E402,F401
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, SigmoidTransform,
    StackTransform, TanhTransform, Transform, TransformedDistribution,
)

@register_kl(Exponential, Exponential)
def _kl_exp(p, q):
    r = q.rate / p.rate
    return Tensor(torch.log(p.rate) - torch.log(q.rate) + r - 1.0)


@register_kl(Gamma, Gamma)
def _kl_gamma(p, q):
    a1, b1, a2, b2 = p.concentration, p.rate, q.concentration, q.rate
    return Tensor((a1 - a2) * torch.digamma(a1)
                  - torch.lgamma(a1) + torch.lgamma(a2)
                  + a2 * (torch.log(b1) - torch.log(b2))
                  + a1 * (b2 - b1) / b1)


@register_kl(Beta, Beta)
def _kl_beta(p, q):
    a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta

    def lb(a, b):
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return Tensor(lb(a2, b2) - lb(a1, b1)
                  + (a1 - a2) * torch.digamma(a1)
                  + (b1 - b2) * torch.digamma(b1)
                  + (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(p, q):
    c1, c2 = p.concentration, q.concentration
    s1 = c1.sum(-1)
    return Tensor(torch.lgamma(s1) - torch.lgamma(c2.sum(-1))
                  - torch.sum(torch.lgamma(c1), -1)
                  + torch.sum(torch.lgamma(c2), -1)
                  + torch.sum((c1 - c2) * (torch.digamma(c1)
                                           - torch.digamma(s1)[..., None]), -1))


@register_kl(Laplace, Laplace)
def _kl_laplace(p, q):
    d = torch.abs(p.loc - q.loc)
    r = p.scale / q.scale
    return Tensor(torch.log(q.scale) - torch.log(p.scale) + d / q.scale
                  + r * torch.exp(-d / p.scale) - 1.0)
