"""Bijective transforms and ``TransformedDistribution`` — counterpart
of ``paddle_tpu/distribution/transform.py``: forward, inverse and
log-det-Jacobian are the reference's expressions over torch values."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.tensor import Tensor
from . import Distribution, _params, _val

__all__ = [
    "Transform", "AffineTransform", "ExpTransform", "SigmoidTransform",
    "TanhTransform", "PowerTransform", "AbsTransform", "ChainTransform",
    "IndependentTransform", "StackTransform", "TransformedDistribution",
]


class Transform:
    """Bijection y = f(x). Subclasses implement ``_forward``,
    ``_inverse`` and ``_forward_log_det_jacobian`` on torch values."""

    #: dims of a single event the jacobian is computed over (0 = scalar)
    event_dim = 0

    def forward(self, x):
        return Tensor(self._forward(_val(x)))

    def inverse(self, y):
        return Tensor(self._inverse(_val(y)))

    def forward_log_det_jacobian(self, x):
        return Tensor(self._forward_log_det_jacobian(_val(x)))

    def inverse_log_det_jacobian(self, y):
        return Tensor(-self._forward_log_det_jacobian(
            self._inverse(_val(y))))


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def _forward(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def _forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(self.scale)).expand(x.shape)


class ExpTransform(Transform):
    """y = exp(x)."""

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class SigmoidTransform(Transform):
    """y = sigmoid(x)."""

    def _forward(self, x):
        return 1.0 / (1.0 + torch.exp(-x))

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        # log σ'(x) = -softplus(-x) - softplus(x)
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    """y = tanh(x)."""

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh²x) = 2(log2 - x - softplus(-2x))
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class PowerTransform(Transform):
    """y = x^power (x > 0)."""

    def __init__(self, power):
        self.power = _val(power)

    def _forward(self, x):
        return torch.pow(x, self.power)

    def _inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def _forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(self.power * torch.pow(x, self.power - 1)))


class AbsTransform(Transform):
    """y = |x| — not bijective; inverse returns the positive branch
    (reference behaviour)."""

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y

    def _forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


class ChainTransform(Transform):
    """Composition (applied left to right on forward)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t._forward_log_det_jacobian(x)
            x = t._forward(x)
        return total


class IndependentTransform(Transform):
    """Reinterprets ``reinterpreted_batch_rank`` trailing batch dims of a
    base transform as event dims (jacobian sums over them)."""

    def __init__(self, base, reinterpreted_batch_rank: int):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)
        self.event_dim = base.event_dim + self.rank

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _forward_log_det_jacobian(self, x):
        ld = self.base._forward_log_det_jacobian(x)
        return ld.sum(dim=tuple(range(-self.rank, 0)))


class StackTransform(Transform):
    """Applies the i-th transform to the i-th slice along ``axis``."""

    def __init__(self, transforms, axis: int = 0):
        self.transforms = list(transforms)
        self.axis = axis

    def _map(self, x, attr):
        parts = torch.chunk(x, len(self.transforms), dim=self.axis)
        outs = [getattr(t, attr)(p.squeeze(self.axis))
                for t, p in zip(self.transforms, parts)]
        return torch.stack(outs, dim=self.axis)

    def _forward(self, x):
        return self._map(x, "_forward")

    def _inverse(self, y):
        return self._map(y, "_inverse")

    def _forward_log_det_jacobian(self, x):
        return self._map(x, "_forward_log_det_jacobian")


class TransformedDistribution(Distribution):
    """base distribution pushed through a transform chain
    (reference transformed_distribution.py): sample = f(base.sample()),
    log_prob(y) = base.log_prob(f⁻¹(y)) - log|det J_f(f⁻¹(y))|."""

    def __init__(self, base: Distribution, transforms):
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.base = base
        self.transform = ChainTransform(list(transforms))

    def sample(self, shape=()):
        x = self.base.sample(shape)
        return self.transform.forward(x)

    def rsample(self, shape=()):
        x = self.base.rsample(shape)
        return self.transform.forward(x)

    def log_prob(self, value) -> Tensor:
        y = _val(value)
        x = self.transform._inverse(y)
        base_lp = _val(self.base.log_prob(Tensor(x)))
        ld = self.transform._forward_log_det_jacobian(x)
        # a base with event dims (Dirichlet, MultivariateNormal) returns
        # log_prob with those dims reduced; sum the element-wise log-det
        # over the same trailing dims so shapes agree instead of
        # silently broadcasting to a wrong per-component result
        extra = ld.dim() - base_lp.dim()
        if extra > 0:
            ld = ld.sum(dim=tuple(range(-extra, 0)))
        return Tensor(base_lp - ld)
