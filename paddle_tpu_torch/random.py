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



# ---------------------------------------------------------------------------
# the distributions' draws (``paddle_tpu/distribution``): jax.random's
# algorithms over the same keys, fp32
# ---------------------------------------------------------------------------

#: fp32 machine epsilon and ``epsneg`` (``jnp.finfo(jnp.float32)``)
_EPS = float(np.finfo(np.float32).eps)
_EPSNEG = float(np.finfo(np.float32).epsneg)
_THIRD = float(np.float32(1.0 / 3.0))


def _fma(a, b, c):
    """``a * b + c`` rounded once to fp32, as XLA contracts it on the
    CPU (the product of two fp32 values is exact in fp64)."""
    return (a.double() * b.double() + c).float()


def exponential_draw(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform_draw(key, shape, device=device))


def laplace_draw(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.laplace``: ``sign(u)·log1p(-|u|)``, ``u`` uniform on
    ``[-1 + epsneg, 1)``."""
    u = uniform_draw(key, shape, -1.0 + _EPSNEG, 1.0, device)
    return torch.sign(u) * torch.log1p(-u.abs())


def cauchy_draw(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.cauchy``: ``tan(π·(u − 0.5))``, ``u`` uniform on
    ``[eps, 1)``."""
    u = uniform_draw(key, shape, _EPS, 1.0, device)
    return torch.tan(float(np.float32(np.pi)) * (u - 0.5))


def geometric_draw(key, p: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.geometric`` (trials to the first success, 1-based),
    as fp32: ``floor(log u / log1p(−p)) + 1``."""
    u = uniform_draw(key, shape, device=p.device)
    return torch.floor(torch.log(u) / torch.log1p(-p).expand(u.shape)) + 1


def _gamma_one(keys: torch.Tensor, alpha: torch.Tensor,
               log_space: bool) -> torch.Tensor:
    """``jax.random``'s ``_gamma_one`` (Marsaglia and Tsang) for a batch
    of elements, each with its own key: the same splits and the same
    rejection loop, run together with finished elements frozen."""
    boost = alpha >= 1
    a = torch.where(boost, alpha, alpha + 1)
    d = a - _THIRD
    # XLA rewrites 1/3 / sqrt(d) as 1/3 · rsqrt(d); its CPU rsqrt is an
    # approximation refined by a Newton step, here correctly rounded
    # (the two agree in ~9 of 10 elements, else by an ulp)
    c = _THIRD * torch.rsqrt(d.double()).float()
    ks = prng.split(keys, 2)
    key, subkey = ks[..., 0, :], ks[..., 1, :]
    X = torch.zeros_like(a)
    V = torch.ones_like(a)
    U = torch.full_like(a, 2.0)

    def reject(X, V, U):
        return ((U >= 1 - 0.0331 * (X * X))
                & (torch.log(U) >= X * 0.5 + d * (1 - V + torch.log(V))))

    live = reject(X, V, U)
    while bool(live.any()):
        k3 = prng.split(key, 3)
        key = torch.where(live[..., None], k3[..., 0, :], key)
        xk, uk = k3[..., 1, :], k3[..., 2, :]
        x = torch.zeros_like(a)
        v = torch.full_like(a, -1.0)
        draw = live.clone()
        while bool(draw.any()):
            s2 = prng.split(xk, 2)
            xk = torch.where(draw[..., None], s2[..., 0, :], xk)
            xn = normal_draw(s2[..., 1, :], ())
            vn = _fma(xn, c, 1.0)
            x = torch.where(draw, xn, x)
            v = torch.where(draw, vn, v)
            draw = draw & (v <= 0)
        Un = uniform_draw(uk, ())
        X = torch.where(live, x * x, X)
        V = torch.where(live, v * v * v, V)
        U = torch.where(live, Un, U)
        live = live & reject(X, V, U)
    if log_space:
        log_s = -exponential_draw(subkey, ())
        log_boost = torch.where(boost | (log_s == 0), torch.zeros_like(a),
                                log_s * (1 / alpha))
        return torch.log(d) + torch.log(V) + log_boost
    s = 1 - uniform_draw(subkey, ())
    b = torch.where(boost, torch.ones_like(a), torch.pow(s, 1 / alpha))
    return d * V * b


def gamma_draw(key, a: torch.Tensor, shape: Sequence[int],
               log_space: bool = False) -> torch.Tensor:
    """``jax.random.gamma`` (``loggamma`` with ``log_space``): ``a``
    broadcast to ``shape``, one key a element from ``split(key, n)``."""
    shape = tuple(shape)
    a = a.float().expand(shape).reshape(-1)
    keys = prng.split(_on(key, a.device), a.numel())
    return _gamma_one(keys, a, log_space).reshape(shape)


def beta_draw(key, a: torch.Tensor, b: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.beta``: two log-space gammas under the split keys,
    ``ga / (ga + gb)`` scaled by their max."""
    ka, kb = prng.split(_on(key, a.device), 2).unbind(-2)
    la = gamma_draw(ka, a, shape, log_space=True)
    lb = gamma_draw(kb, b, shape, log_space=True)
    m = torch.maximum(la, lb)
    ga, gb = torch.exp(la - m), torch.exp(lb - m)
    return ga / (ga + gb)


def dirichlet_draw(key, alpha: torch.Tensor,
                   shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.dirichlet``: log-space gammas of ``shape +
    alpha.shape[-1:]``, softmaxed over the last axis."""
    lg = gamma_draw(key, alpha, tuple(shape) + tuple(alpha.shape[-1:]),
                    log_space=True)
    return torch.softmax(lg, dim=-1)


def t_draw(key, df: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.t``: ``n·sqrt(df/2 / gamma(df/2))`` under the split
    keys."""
    kn, kg = prng.split(_on(key, df.device), 2).unbind(-2)
    n = normal_draw(kn, shape)
    half = df.float() / 2
    g = gamma_draw(kg, half, shape)
    return n * torch.sqrt(half / g)


def _poisson_knuth(key, lam, shape):
    k = torch.zeros(shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros(shape, device=lam.device)
    while bool((log_prod > -lam).any()):
        key, sub = prng.split(key, 2).unbind(-2)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + torch.log(uniform_draw(sub, shape))
    return k - 1


def _poisson_rejection(key, lam, shape):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, device=lam.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    while not bool(accepted.all()):
        key, k0, k1 = prng.split(key, 3).unbind(-2)
        u = uniform_draw(k0, shape) - 0.5
        v = uniform_draw(k1, shape)
        us = 0.5 - u.abs()
        k = torch.floor((2 * a / us + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int32)


def poisson_draw(key, lam: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.poisson`` (int32): Knuth's product of uniforms below
    λ = 10, Hörmann's transformed rejection above, both run over the
    whole array under the same key, as JAX runs them."""
    shape = tuple(shape)
    key = _on(key, lam.device)
    lam = lam.float().expand(shape)
    knuth = torch.isnan(lam) | (lam < 10)
    lk = torch.where(knuth, lam, torch.zeros_like(lam))
    lr = torch.where(knuth, torch.full_like(lam, 1e5), lam)
    out = torch.where(knuth, _poisson_knuth(key, lk, shape),
                      _poisson_rejection(key, lr, shape))
    return torch.where(lam == 0, torch.zeros_like(out), out)


_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092,
                  0.0276779256849983, 0.02079067210376509,
                  0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)


def _stirling_approx_tail(k):
    vals = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    use = k <= 9
    kc = k.clamp(0.0, 9.0)
    kp1sq = (kc + 1) * (kc + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (kc + 1)
    return torch.where(use, vals[torch.floor(kc).long()], approx)


def _binomial_inversion(key, count, prob, shape):
    log1mp = torch.log1p(-prob)
    num_geom = torch.zeros(shape, device=prob.device)
    geom_sum = torch.zeros(shape, device=prob.device)
    while bool((geom_sum <= count).any()):
        sub, key = prng.split(key, 2).unbind(-2)
        num_geom = torch.where(geom_sum <= count, num_geom + 1, num_geom)
        u = uniform_draw(sub, shape)
        geom_sum = geom_sum + torch.ceil(torch.log(u) / log1mp)
    return num_geom - 1


def _btrs(key, count, prob, shape):
    std = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * std
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - 4.2 / b
    r = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * std
    m = torch.floor((count + 1) * prob)
    k_out = torch.full(shape, -1.0, device=prob.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=prob.device)
    while not bool(accepted.all()):
        key, k0, k1 = prng.split(key, 3).unbind(-2)
        u = uniform_draw(k0, shape)
        v = uniform_draw(k1, shape)
        u = u - 0.5
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
              + _stirling_approx_tail(m) + _stirling_approx_tail(count - m)
              - _stirling_approx_tail(k) - _stirling_approx_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out


def binomial_draw(key, count: torch.Tensor, prob: torch.Tensor,
                  shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.binomial`` (fp32): inversion by geometric sums where
    ``n·q ≤ 10``, BTRS rejection elsewhere (``q = min(p, 1 − p)``), both
    run over the whole array under the same key; NaN for a negative or
    NaN count or an invalid p, inf for an infinite count."""
    shape = tuple(shape)
    key = _on(key, prob.device)
    prob = prob.float().expand(shape)
    count = count.float().expand(shape)
    lt_half = prob < 0.5
    q = torch.where(lt_half, prob, 1.0 - prob)
    bad_count = torch.isnan(count) | (count < 0.0)
    inf_count = torch.isinf(count)
    q_nan = torch.isnan(q)
    q_neg = q < 0.0
    q = torch.where(q_nan | q_neg, torch.full_like(q, 0.01), q)
    inv = bad_count | (count * q <= 10.0)
    count = torch.floor(count)
    c_inv = torch.where(inv, count, torch.zeros_like(count))
    c_btrs = torch.where(inv, torch.full_like(count, 1e4), count)
    q_btrs = torch.where(inv, torch.full_like(q, 0.5), q)
    out = torch.where(inv, _binomial_inversion(key, c_inv, q, shape),
                      _btrs(key, c_btrs, q_btrs, shape))
    invalid = q_neg | q_nan | bad_count
    out = torch.where(invalid, torch.full_like(out, float("nan")), out)
    out = torch.where(inf_count & ~invalid, torch.full_like(out, float("inf")),
                      out)
    return torch.where(lt_half | bad_count | q_nan | inf_count, out,
                       count - out)


__all__ = ["seed", "next_key", "get_rng_state", "set_rng_state",
           "traced_key_scope"]
