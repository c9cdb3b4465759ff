"""Counter-based random numbers: the port's copy of the ``jax.random``
functions the JAX package's decoding calls, reproducing their bits.

JAX keys its draws with Threefry-2x32 (the default ``threefry2x32``
implementation, partitionable mode). Threefry is a fixed integer hash,
so the same keys, counters and bit manipulations give the same bits in
PyTorch:

* ``prng_key(s)`` is ``[0, s]`` (a 32-bit seed padded with zeros);
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``split(k, n)[i]`` is ``threefry2x32(k, (0, i))``;
* ``bits(k, shape)`` at flat index ``i`` is ``x0 ^ x1`` of
  ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
* ``uniform`` puts the top 23 bits under the exponent of 1.0
  (``(bits >> 9) | 0x3F800000`` viewed as fp32), subtracts 1, scales by
  ``maxval - minval``, adds ``minval`` and clamps at ``minval``;
* ``gumbel`` is ``-log(-log(u))`` with ``u`` uniform on
  ``[finfo.tiny, 1)`` (JAX's "low" mode);
* ``categorical`` is the argmax of ``gumbel + logits`` (ties to the
  first index).

A key is an int64 tensor ``(..., 2)`` holding two uint32 values; every
leading dimension is a batch of keys (``jax.vmap`` over keys). torch has
no full uint32 arithmetic, so the values ride in int64 and every sum and
rotation is masked back to 32 bits. The functions are pure tensor ops
with no generator state and no host synchronisation, so they run inside
a CUDA graph. Only ``log`` can differ from XLA's, by an ulp.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
#: Threefry-2x32's rotation schedule (two alternating groups of four)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: smallest normal fp32 (``jnp.finfo(jnp.float32).tiny``)
FP32_TINY = 1.1754943508222875e-38


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``; int64 tensors of uint32 values that
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _u32(v, device=None) -> torch.Tensor:
    """An int or tensor of seeds/data as int64 uint32 values (a negative
    int32 wraps as ``jnp.uint32`` converts it). An int becomes a fill on
    ``device``, never a host-to-device copy (which a graph capture
    refuses); a tensor stays where it is."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    return torch.full((), int(v) & MASK, dtype=torch.int64, device=device)


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` / ``jax.random.key(seed)`` for 32-bit
    seeds: ``[0, seed]``. A tensor of seeds gives a batch of keys."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _hash(key: torch.Tensor, hi, lo) -> torch.Tensor:
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))``; ``data``
    is an int or a tensor broadcasting with the key batch."""
    d = _u32(data, key.device)
    return _hash(key, torch.zeros_like(d), d)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)``, key ``i`` being
    ``threefry2x32(key, (0, i))``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key[..., None, :], torch.zeros_like(i), i)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of ``shape`` for each key:
    ``key.shape[:-1] + shape`` int64 tensor of uint32 values."""
    shape = tuple(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], i >> 32, i & MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in fp32 on ``[minval, maxval)``."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds as fp32 values, taken on the host (no copy to the card
    # inside a graph capture); fp32 arithmetic with them is JAX's
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32)
                 - torch.tensor(minval, dtype=torch.float32))
    return torch.clamp_min(f * span + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (fp32, "low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=FP32_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, as int64
    indices. A batch of keys ``(B..., 2)`` draws for each the rows of
    ``logits[B...]`` (``jax.vmap`` over keys and rows); one key ``(2,)``
    draws the whole ``logits`` as one array (the counters run over every
    element, as in one unbatched call)."""
    nb = key.dim() - 1
    g = gumbel(key, logits.shape[nb:])
    return torch.argmax(g + logits, dim=-1)

