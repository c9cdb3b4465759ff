"""Weight initializers — counterpart of ``paddle_tpu/nn/initializer.py``.

An initializer is a callable ``(shape, dtype) -> tensor`` that draws from
the framework key stream (``random.next_key()``), one key a call, as the
reference's draw from its own: after ``seed(s)`` both packages build the
same weights and leave the stream at the same point. Uniform and
Xavier/Kaiming-uniform draws are the reference's bit for bit; normal,
truncated-normal and orthogonal ones to an ulp of XLA's ``erfinv`` (and
the QR's rounding). Each draw is in fp32, then cast to ``dtype``, on ``device``
(keyword-only; ``None`` is the current place, the card unless
``set_device`` says otherwise).

The in-place fill helpers below the classes (``constant_``, ``normal_``,
``xavier_uniform_``) take a ``torch.Generator`` instead: the port's own
``init_layers`` and ``models.*.init`` redraw whole models with them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import random as _random
from ..core import place as _place
from ..core.dtype import convert_dtype
from ..core.tensor import to_torch
from ..ops._common import resolve_device


def init_device(device=None) -> torch.device:
    """``device``, or when None the place ``set_device`` set, else the
    card (raising without one)."""
    if device is None and _place._current_place[0] is not None:
        return _place._current_place[0].torch_device()
    return resolve_device(device)


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _dt(dtype):
    return convert_dtype(dtype) or torch.float32


def _uniform(shape, dtype, low, high, device):
    return _random.uniform_draw(_random.next_key(), tuple(shape), low, high,
                                device=init_device(device)).to(_dt(dtype))


def _normal(shape, dtype, mean, std, device):
    z = _random.normal_draw(_random.next_key(), tuple(shape),
                            device=init_device(device))
    return _affine(z, std, mean).to(_dt(dtype))


def _affine(z, std, mean):
    """``z * std + mean`` rounded once to fp32, as XLA's fused
    multiply-add rounds it."""
    return (z.double() * float(np.float32(std))
            + float(np.float32(mean))).float()


class Initializer:
    def __call__(self, shape, dtype, *, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, *, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype),
                          device=init_device(device))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, *, device=None):
        return _uniform(shape, dtype, self.low, self.high, device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, *, device=None):
        return _normal(shape, dtype, self.mean, self.std, device)


def truncated_normal_draw(key, lower, upper, shape, device=None):
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    ``sqrt(2)·erfinv(u)`` with ``u`` uniform between ``erf(lower/√2)``
    and ``erf(upper/√2)``, clamped inside ``(lower, upper)``. The two
    bounds are rounded to fp32 from double precision."""
    sqrt2 = np.float32(np.sqrt(2.0))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    u = _random.uniform_draw(key, tuple(shape), a, b, device=device)
    out = float(sqrt2) * _random.erfinv(u)
    return torch.clamp(out, float(np.nextafter(lo, np.float32(np.inf))),
                       float(np.nextafter(hi, np.float32(-np.inf))))


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, *, device=None):
        z = truncated_normal_draw(_random.next_key(), -2.0, 2.0, shape,
                                  device=init_device(device))
        return _affine(z, self.std, self.mean).to(_dt(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype, *, device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit, device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype, *, device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        return _normal(shape, dtype, 0.0, math.sqrt(2.0 / (fi + fo)), device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype, *, device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype, *, device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return _normal(shape, dtype, 0.0, gain / math.sqrt(fi), device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, *, device=None):
        v = getattr(self.value, "_value", self.value)
        v = to_torch(v, init_device(device)).to(_dt(dtype))
        assert tuple(v.shape) == tuple(shape), (v.shape, shape)
        return v


def orthogonal_draw(key, n, shape, device=None):
    """``jax.random.orthogonal(key, n, shape)``: the Q of a normal
    ``(*shape, n, n)`` draw's QR, its columns' signs fixed by R's
    diagonal."""
    z = _random.normal_draw(key, tuple(shape) + (n, n), device=device)
    q, r = torch.linalg.qr(z)
    d = torch.diagonal(r, 0, -2, -1)
    return q * (d / d.abs()).unsqueeze(-2)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, *, device=None):
        key, dev = _random.next_key(), init_device(device)
        shape = tuple(shape)
        if len(shape) > 2:
            q = orthogonal_draw(key, shape[-1], shape[:-2], dev)
        else:
            q = orthogonal_draw(key, max(shape), (), dev)[:shape[0], :shape[1]]
        return q.to(_dt(dtype)) * self.gain


# calculate_gain parity
def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]


# ---------------------------------------------------------------------------
# in-place fills from a torch.Generator (the port's init_layers helpers)
# ---------------------------------------------------------------------------

def constant_(t, value):
    with torch.no_grad():
        t.fill_(value)


def normal_(t, gen=None, mean=0.0, std=1.0):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                            dtype=torch.float32) * std + mean)


def xavier_uniform_(t, gen=None):
    """Uniform in ±sqrt(6 / (fan_in + fan_out)), the fans of a 2-D
    ``(in, out)`` weight being its two sizes (``_fans``)."""
    fan_in, fan_out = t.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        u = torch.rand(t.shape, generator=gen, device=t.device,
                       dtype=torch.float32)
        t.copy_(u * (2 * limit) - limit)
