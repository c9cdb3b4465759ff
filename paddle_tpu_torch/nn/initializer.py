"""The initialisers of ``paddle_tpu/nn/initializer.py`` that the ported
layers use, filling a tensor in place from a ``torch.Generator`` (torch's
default one for the tensor's device when ``gen`` is ``None``): the same
distributions as the reference (drawn in fp32, then cast), not the same
bits. Tests carry the JAX package's weights across instead."""

from __future__ import annotations

import math

import torch


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
