"""``paddle.linalg`` namespace — counterpart of ``paddle_tpu/linalg.py``.

Every function goes through the dispatcher (``core.dispatch.apply``)
under the reference's op name, so AMP and the taps see it. The
decompositions and solvers are ``torch.linalg``'s (LAPACK on the host,
cuSOLVER and cuBLAS on the card), as the reference leaves them to XLA;
where the reference composes a result itself (``lstsq`` over an SVD,
``matrix_rank``'s tolerance, ``lu``'s info, ``svd_lowrank``'s sketch,
the ``UPLO`` triangle) the port composes it the same way.

Outputs that are unique only up to a sign or phase (``qr``, ``svd``,
``eig``, ``eigh``, ``householder_product``) follow the library's
choice, which may differ from the reference's.

Every SVD on the card (``svd``, ``cond``, ``pinv``, ``matrix_rank``,
``lstsq``, ``svd_lowrank``) is cuSOLVER's QR-iteration ``gesvd``: torch's
default there, the Jacobi ``gesvdj``, stops short on a (2048, 2048) fp32
matrix (reconstruction 6.4e-4 and orthogonality 1.0e-3 against gesvd's
9.0e-6 and 5.7e-5 on the H100, ``chip_smoke.py`` phase 40).
"""

from __future__ import annotations

import torch

from .core.dispatch import apply
from .core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _op(name, fn, *args, **static):
    return apply(fn, *[_t(a) for a in args], op_name=name, **static)


def _svd_algo(v):
    return "gesvd" if v.is_cuda else None


def _svd(v, full_matrices=False):
    return torch.linalg.svd(v, full_matrices=full_matrices,
                            driver=_svd_algo(v))


def _svdvals(v):
    return torch.linalg.svdvals(v, driver=_svd_algo(v))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    from .core import math_ops as M
    return M.matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    # the flattened vector norm when axis is None, as the Tensor method
    from .core import math_ops as M
    return M.norm(x, p=p, axis=axis, keepdim=keepdim)


def cond(x, p=None, name=None):
    def fn(v):
        if p in (None, 2, -2):
            s = _svdvals(v)
            big, small = s[..., 0], s[..., -1]
            return big / small if p != -2 else small / big
        return torch.linalg.cond(v, p=p)
    return _op("cond", fn, x)


def inv(x, name=None):
    return _op("inv", torch.linalg.inv, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    def fn(v):
        if hermitian:
            return torch.linalg.pinv(v, rtol=rcond, hermitian=True)
        # jnp.linalg.pinv: singular values at most rcond · the largest
        # are dropped
        u, s, vh = _svd(v)
        cut = rcond * s[..., :1]
        s_inv = torch.where(s > cut, 1 / s, torch.zeros_like(s))
        return (vh.mH * s_inv[..., None, :]) @ u.mH
    return _op("pinv", fn, x)


def det(x, name=None):
    return _op("det", torch.linalg.det, x)


def slogdet(x, name=None):
    def fn(v):
        sign, logabs = torch.linalg.slogdet(v)
        return torch.stack([sign, logabs])
    return _op("slogdet", fn, x)


def cholesky(x, upper=False, name=None):
    def fn(v):
        lo = torch.linalg.cholesky(v)
        return lo.transpose(-1, -2) if upper else lo
    return _op("cholesky", fn, x)


def qr(x, mode="reduced", name=None):
    if mode == "r":
        # the bare R matrix, as the reference returns it
        return _op("qr", lambda v: torch.linalg.qr(v, mode="r")[1], x)
    return _op("qr", lambda v: tuple(torch.linalg.qr(v, mode=mode)), x)


def svd(x, full_matrices=False, name=None):
    return _op("svd", lambda v: tuple(_svd(v, full_matrices)), x)


def eig(x, name=None):
    return _op("eig", lambda v: tuple(torch.linalg.eig(v)), x)


def _from_triangle(v, UPLO):
    """The symmetric matrix read from one triangle (Paddle's UPLO)."""
    if UPLO == "L":
        return torch.tril(v) + torch.tril(v, -1).transpose(-1, -2)
    return torch.triu(v) + torch.triu(v, 1).transpose(-1, -2)


def eigh(x, UPLO="L", name=None):
    return _op("eigh", lambda v: tuple(
        torch.linalg.eigh(_from_triangle(v, UPLO))), x)


def eigvals(x, name=None):
    return _op("eigvals", torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return _op("eigvalsh", lambda v: torch.linalg.eigvalsh(
        _from_triangle(v, UPLO)), x)


def _solve(a, b):
    """``jnp.linalg.solve``: ``b`` is a vector only when it is 1-D, else
    a batch of matrices broadcast against ``a``'s batch."""
    if b.dim() == 1:
        return torch.linalg.solve(a, b[:, None])[..., 0]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.linalg.solve(a.expand(batch + a.shape[-2:]),
                              b.expand(batch + b.shape[-2:]))


def solve(x, y, name=None):
    return _op("solve", _solve, x, y)


def _solve_triangular(a, b, lower: bool, trans: bool, unit: bool):
    """``jax.scipy.linalg.solve_triangular``: ``b`` of ``a``'s rank less
    one is a vector; ``trans`` solves ``aᵀ z = b``."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    if trans:
        a, lower = a.transpose(-1, -2), not lower
    z = torch.linalg.solve_triangular(a, b, upper=not lower,
                                      unitriangular=unit)
    return z[..., 0] if vec else z


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return _op("triangular_solve",
               lambda a, b: _solve_triangular(a, b, not upper, transpose,
                                              unitriangular), x, y)


def _lstsq(a, b, rcond):
    """``jnp.linalg.lstsq`` (2-D ``a``): the SVD solution with singular
    values under ``rcond · s[0]`` dropped (``rcond`` None: eps·max(M,
    N)), the full residuals ``‖b − a x‖²`` per column, the rank and the
    singular values."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = float(torch.finfo(a.dtype).eps) * max(n, m)
    elif rcond < 0:
        rcond = float(torch.finfo(a.dtype).eps)
    u, s, vt = _svd(a)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    x = vt.conj().T @ (s_inv * (u.conj().T @ b))
    resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
    if vec:
        x = x.reshape(-1)
    return x, resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    return _op("lstsq", lambda a, b: _lstsq(a, b, rcond), x, y)


def matrix_power(x, n, name=None):
    return _op("matrix_power", lambda v: torch.linalg.matrix_power(v, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    def fn(v):
        s = torch.linalg.eigvalsh(v).abs() if hermitian else _svdvals(v)
        if tol is None:
            # numpy's default: max(dims) · eps · the largest singular value
            t = (max(v.shape[-2:]) * float(torch.finfo(v.dtype).eps)
                 * s.amax(dim=-1, keepdim=True))
        else:
            t = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
        return (s > t).sum(dim=-1).to(torch.int32)
    return _op("matrix_rank", fn, x)


def multi_dot(xs, name=None):
    return apply(lambda *vs: torch.linalg.multi_dot(vs),
                 *[_t(v) for v in xs], op_name="multi_dot")


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` given ``y``, the Cholesky factor of A (Paddle's
    argument order: x is the right-hand side, y the factor)."""
    def fn(b, f):
        if upper:
            z = _solve_triangular(f, b, False, True, False)
            return _solve_triangular(f, z, False, False, False)
        z = _solve_triangular(f, b, True, False, False)
        return _solve_triangular(f, z, True, True, False)

    return _op("cholesky_solve", fn, x, y)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    extra = [w for w in (fweights, aweights) if w is not None]
    has_f, has_a = fweights is not None, aweights is not None

    def fn(v, *ws):
        it = iter(ws)
        fw = next(it) if has_f else None
        aw = next(it) if has_a else None
        if not v.dtype.is_floating_point:
            v = v.float()
        if not rowvar and v.dim() > 1:
            v = v.T
        return torch.cov(v, correction=1 if ddof else 0, fweights=fw,
                         aweights=aw)

    return _op("cov", fn, x, *extra)


def corrcoef(x, rowvar=True, name=None):
    def fn(v):
        if not v.dtype.is_floating_point:
            v = v.float()
        return torch.corrcoef(v if rowvar or v.dim() < 2 else v.T)
    return _op("corrcoef", fn, x)


def lu(x, pivot=True, get_infos=False, name=None):
    """LU factorization with partial pivoting, as the reference factors
    whatever ``pivot`` says: ``(LU packed, pivots[, infos])``, the pivots
    1-based row swaps (int32); ``infos`` the 1-based index of the first
    zero on U's diagonal, 0 where none."""
    def fn(v):
        packed, pivots, _ = torch.linalg.lu_factor_ex(v)
        outs = (packed, pivots.to(torch.int32))
        if get_infos:
            zero = torch.diagonal(packed, dim1=-2, dim2=-1) == 0
            first = torch.argmax(zero.to(torch.int32), dim=-1) + 1
            info = torch.where(zero.any(dim=-1), first,
                               torch.zeros_like(first)).to(torch.int32)
            outs = outs + (info,)
        return outs

    return _op("lu", fn, x, n_outputs=3 if get_infos else 2)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """``(P, L, U)`` from the packed factorization, ``A = P L U`` (the
    reference returns all three whatever the flags say)."""
    def fn(packed, piv):
        return tuple(torch.lu_unpack(packed, piv.to(torch.int32)))

    return _op("lu_unpack", fn, lu_data, lu_pivots, n_outputs=3)


def householder_product(x, tau, name=None):
    """Q (m × n) from Householder reflectors in geqrf's layout."""
    return _op("householder_product", torch.linalg.householder_product,
               x, tau)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """``other`` times the full m × m Q of a geqrf factorization
    (LAPACK's ormqr)."""
    return _op("ormqr", lambda a, t, o: torch.ormqr(
        a, t, o, left=left, transpose=transpose), x, tau, other)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized truncated SVD (Halko et al.): the sketch is
    ``jax.random.normal(jax.random.key(0), (n, k))``, the reference's
    fixed draw, from the port's key stream."""
    from . import random as R
    from .inference import prng

    extra = [M] if M is not None else []

    def fn(a, *rest):
        if rest:
            a = a - rest[0]          # the SVD of A - M (the centred path)
        m, n = a.shape[-2], a.shape[-1]
        k = min(q, m, n)
        g = R.normal_draw(prng.prng_key(0, device=a.device), (n, k),
                          device=a.device).to(a.dtype)
        y = a @ g
        for _ in range(niter):
            # re-orthonormalized each pass, or y grows as
            # sigma_max^(2·niter+1) and overflows fp32
            qy, _ = torch.linalg.qr(y)
            y = a @ (a.transpose(-1, -2) @ qy)
        qmat, _ = torch.linalg.qr(y)
        b = qmat.transpose(-1, -2) @ a
        u, s, vh = _svd(b)
        return qmat @ u, s, vh.transpose(-1, -2)

    return _op("svd_lowrank", fn, x, *extra, n_outputs=3)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    def fn(v):
        return torch.linalg.vector_norm(v, ord=p, dim=axis, keepdim=keepdim)
    return _op("vector_norm", fn, x)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    ax = tuple(axis)
    return _op("matrix_norm", lambda v: torch.linalg.matrix_norm(
        v, ord=p, dim=ax, keepdim=keepdim), x)

