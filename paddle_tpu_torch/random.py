"""Framework RNG state — counterpart of ``paddle_tpu/random.py``.

One global key advances by a fold-in counter, as in the JAX package:
``seed(s)`` makes the key ``jax.random.key(s)`` (``[0, s]``) and each
draw folds the next counter value into it. The keys and the draws run
on ``inference.prng``'s Threefry bits, so the same seed gives the JAX
package's draws: ``rand``, ``uniform``, ``randint``, ``bernoulli``,
``randperm``, ``multinomial`` and the dropout masks bit for bit (a
multinomial draw can differ only where ``log`` rounds differently and
two candidates are within an ulp), ``randn``/``normal`` to an ulp of
XLA's ``erfinv`` (:func:`erfinv` is its polynomial).

The functions below are the draws of ``jax.random`` the eager API uses,
over a key of this module (an int64 tensor ``(2,)`` holding two uint32
values, see ``inference.prng``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .inference import prng

MASK = prng.MASK
#: fp32 ``nextafter(-1, 0)``: the lower bound of ``jax.random.normal``'s
#: uniform draw
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


class _RNGState:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self.base_key = prng.prng_key(seed)
        self.counter = 0
        #: the key of a compiled program's call, while its body runs
        #: (:class:`traced_key_scope`); None outside
        self.traced_key = None

    def next_key(self):
        self.counter += 1
        if self.traced_key is not None:
            return prng.fold_in(self.traced_key, self.counter)
        return prng.fold_in(self.base_key, self.counter)


_state = _RNGState(0)


def seed(s: int) -> None:
    """Parity with ``paddle.seed``."""
    global _state
    _state = _RNGState(int(s))


def next_key():
    return _state.next_key()


def get_rng_state():
    return (_state.counter, _state.base_key)


def set_rng_state(state) -> None:
    _state.counter, _state.base_key = state


class traced_key_scope:
    """The key stream inside a compiled program's body (``jit``): draws
    fold a counter reset to 0 into ``key``, the call's own key, as the
    reference's traced key does (``paddle_tpu/random.py:41-46, 70-84``).
    ``key`` is a static device input of the program, written before
    each replay, so ``fold_in`` runs on the card inside the graph and
    every call draws fresh masks."""

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        self.prev = (_state.traced_key, _state.counter)
        _state.traced_key = self.key
        _state.counter = 0
        return self

    def __exit__(self, *exc):
        _state.traced_key, _state.counter = self.prev
        return False


# ---------------------------------------------------------------------------
# jax.random's draws over a key (fp32 and int32, as the eager API asks)
# ---------------------------------------------------------------------------

def _on(key: torch.Tensor, device) -> torch.Tensor:
    return key.to(device) if device is not None else key


def uniform_draw(key, shape: Sequence[int], minval=0.0, maxval=1.0,
                 device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``. XLA
    fuses its ``floats * (maxval - minval) + minval`` into one rounding
    (a fused multiply-add), so the scaling is done in fp64 (the product
    of two fp32 values is exact there) and rounded to fp32 once."""
    f = prng.uniform(_on(key, device), tuple(shape))      # [0, 1)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    if span == 1.0 and lo == 0.0:
        return f
    out = (f.double() * float(span) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


#: XLA's single-precision ``erf_inv`` (Giles' approximation): the
#: polynomial coefficients for ``w < 5`` and for ``w >= 5``
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``erf⁻¹`` as XLA computes it (``jax.scipy.special.erfinv``):
    ``w = −log1p(−x²)``, a degree-8 polynomial in ``w − 2.5`` or
    ``√w − 3``, each step one fused multiply-add (rounded once, from
    fp64), times ``x``. It agrees with XLA's to an ulp, where
    ``torch.erfinv`` (accurate to an ulp of the true value) differs from
    XLA's by up to 1.5e-5 near ±1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    coef = torch.where(lt[..., None], lo, hi).double()
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef[..., i] + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1, x * float(np.finfo(np.float32).max),
                       out)


def normal_draw(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erfinv(u)``
    with ``u`` uniform on ``[nextafter(-1, 0), 1)`` and XLA's
    :func:`erfinv`."""
    u = uniform_draw(key, shape, _NORMAL_LO, 1.0, device)
    return _SQRT2 * erfinv(u)


def bernoulli_draw(key, p, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` (p as
    fp32)."""
    u = uniform_draw(key, shape, device=device)
    if isinstance(p, torch.Tensor):
        return u < p.to(torch.float32)
    return u < float(np.float32(p))


def randint_draw(key, shape: Sequence[int], minval: int, maxval: int,
                 device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two
    32-bit draws folded into ``[minval, maxval)`` modulo the span, in
    uint32 arithmetic (JAX's exact steps, its bias included)."""
    info = np.iinfo(np.int32)
    lo = int(np.clip(minval, info.min, info.max))
    hi = int(np.clip(maxval, info.min, info.max))
    k1, k2 = prng.split(_on(key, device), 2).unbind(-2)
    shape = tuple(shape)
    higher, lower = prng.bits(k1, shape), prng.bits(k2, shape)
    span = 1 if hi <= lo else (hi - lo) & MASK
    if maxval > info.max and hi > lo:
        span = (span + 1) & MASK
    if span == 0:                    # a 2**32 span: the draw is lower
        off = lower
    else:
        mult = ((2 ** 16 % span) ** 2 & MASK) % span
        off = (((higher % span) * mult & MASK) + lower % span & MASK) % span
    off = torch.where(off >= 2 ** 31, off - 2 ** 32, off)
    return (lo + off).to(torch.int32)


def permutation_draw(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` sorted (stably)
    by fresh 32-bit keys, in the number of rounds JAX takes."""
    key = _on(key, device)
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = prng.split(key, 2).unbind(-2)
        order = torch.argsort(prng.bits(sub, (n,)), stable=True)
        x = x[order]
    return x


def gumbel_draw(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` ("low" mode)."""
    return prng.gumbel(_on(key, device), tuple(shape))


def categorical_draw(key, logits: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape=shape)``:
    the argmax of ``gumbel + logits`` over the last axis, the Gumbel
    noise of shape ``shape[:-batch] + logits.shape``."""
    batch = tuple(logits.shape[:-1])
    prefix = tuple(shape)[:len(shape) - len(batch)]
    g = gumbel_draw(key, prefix + tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)


__all__ = ["seed", "next_key", "get_rng_state", "set_rng_state",
           "traced_key_scope"]
