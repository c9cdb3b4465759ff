"""Public op surface (the ``paddle.*`` tensor-math namespace) —
counterpart of ``paddle_tpu/core/math_ops.py``, with the same functions,
Paddle calling conventions (``axis``, ``keepdim``, ``transpose_x`` /
``transpose_y`` on matmul, list-of-sections ``split``) and result dtypes
(int32 indices and counts, as under the reference's x64-off JAX). Every
op funnels through ``dispatch.apply``; torch's autograd records the
graph.
"""

from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np
import torch

from .dispatch import apply, unwrap
from .dtype import canonical_dtype, convert_dtype
from .tensor import Tensor


def _t(x) -> Tensor:
    return x if isinstance(x, Tensor) else Tensor(x)


def _scalar(x):
    return isinstance(x, (int, float, bool, complex))


def _like(v, ref):
    """A Python scalar as a 0-d tensor beside ``ref`` (0-d tensors take
    part in type promotion as scalars do: weakly)."""
    return torch.as_tensor(v, device=ref.device) if _scalar(v) else v


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------
def _binary(name, fn):
    def op(x, y, name=None):
        return apply(fn, _t(x) if not _scalar(x) else x,
                     _t(y) if not _scalar(y) else y, op_name=name_)
    name_ = name
    op.__name__ = name
    return op


def _tensors(fn):
    """``fn(a, b)`` for a torch function that wants two tensors: a Python
    scalar operand becomes a 0-d tensor beside the other."""
    def run(a, b):
        if _scalar(a):
            a = _like(a, b)
        elif _scalar(b):
            b = _like(b, a)
        return fn(a, b)
    return run


add = _binary("add", lambda x, y: x + y)
subtract = _binary("subtract", lambda x, y: x - y)
multiply = _binary("multiply", lambda x, y: x * y)
divide = _binary("divide", _tensors(torch.true_divide))
floor_divide = _binary("floor_divide", _tensors(torch.floor_divide))
remainder = _binary("remainder", _tensors(torch.remainder))
mod = remainder
floor_mod = remainder
pow = _binary("pow", _tensors(torch.pow))
maximum = _binary("maximum", _tensors(torch.maximum))
minimum = _binary("minimum", _tensors(torch.minimum))
fmax = maximum
fmin = minimum
atan2 = _binary("atan2", _tensors(torch.atan2))
hypot = _binary("hypot", _tensors(torch.hypot))

logical_and = _binary("logical_and", _tensors(torch.logical_and))
logical_or = _binary("logical_or", _tensors(torch.logical_or))
logical_xor = _binary("logical_xor", _tensors(torch.logical_xor))
bitwise_and = _binary("bitwise_and", _tensors(torch.bitwise_and))
bitwise_or = _binary("bitwise_or", _tensors(torch.bitwise_or))
bitwise_xor = _binary("bitwise_xor", _tensors(torch.bitwise_xor))

equal = _binary("equal", _tensors(torch.eq))
not_equal = _binary("not_equal", _tensors(torch.ne))
greater_than = _binary("greater_than", _tensors(torch.gt))
greater_equal = _binary("greater_equal", _tensors(torch.ge))
less_than = _binary("less_than", _tensors(torch.lt))
less_equal = _binary("less_equal", _tensors(torch.le))


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
def _unary(name, fn):
    def op(x, name=None):
        return apply(fn, _t(x), op_name=name_)
    name_ = name
    op.__name__ = name
    return op


def _float_in(fn):
    """``fn`` over a floating input (an integer input is promoted to the
    default float first, as jnp's transcendental functions do)."""
    def run(v):
        if not (v.dtype.is_floating_point or v.dtype.is_complex):
            v = v.to(torch.get_default_dtype())
        return fn(v)
    return run


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", _float_in(torch.rsqrt))
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
sigmoid = _unary("sigmoid", _float_in(torch.sigmoid))
erf = _unary("erf", _float_in(torch.erf))
erfinv = _unary("erfinv", _float_in(torch.erfinv))
square = _unary("square", torch.square)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", torch.reciprocal)
logical_not = _unary("logical_not", torch.logical_not)
bitwise_not = _unary("bitwise_not", torch.bitwise_not)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
digamma = _unary("digamma", _float_in(torch.digamma))
lgamma = _unary("lgamma", _float_in(torch.lgamma))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    if bias_after_scale:
        out = apply(lambda v: v * scale + bias, _t(x), op_name="scale")
    else:
        out = apply(lambda v: (v + bias) * scale, _t(x), op_name="scale")
    return out


def clip(x, min=None, max=None, name=None):
    lo = unwrap(min) if isinstance(min, Tensor) else min
    hi = unwrap(max) if isinstance(max, Tensor) else max
    return apply(lambda v: torch.clamp(v, lo, hi), _t(x), op_name="clip")


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return apply(lambda a, b, w: a + w * (b - a), _t(x), _t(y), weight, op_name="lerp")
    return apply(lambda a, b: a + weight * (b - a), _t(x), _t(y), op_name="lerp")


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _norm_axis(axis):
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis if axis is None else int(axis)


def _dims(v, ax):
    """The reduced dims of ``v`` for a Paddle ``axis`` (None: all)."""
    if ax is None:
        return tuple(range(v.dim()))
    return (ax,) if isinstance(ax, int) else ax


def _sum(v, axis, keepdims):
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    return torch.sum(v, dim=_dims(v, axis), keepdim=keepdims)


def _mean(v, axis, keepdims):
    if not (v.dtype.is_floating_point or v.dtype.is_complex):
        v = v.to(torch.get_default_dtype())
    return torch.mean(v, dim=_dims(v, axis), keepdim=keepdims)


def _prod(v, axis, keepdims):
    for d in sorted(_dims(v, axis), reverse=True):
        v = torch.prod(v, dim=d, keepdim=keepdims)
    return v


def _amax(v, axis, keepdims):
    return torch.amax(v, dim=_dims(v, axis), keepdim=keepdims)


def _amin(v, axis, keepdims):
    return torch.amin(v, dim=_dims(v, axis), keepdim=keepdims)


def _all(v, axis, keepdims):
    return torch.all(v.bool(), dim=_dims(v, axis), keepdim=keepdims)


def _any(v, axis, keepdims):
    return torch.any(v.bool(), dim=_dims(v, axis), keepdim=keepdims)


def _logsumexp(v, axis, keepdims):
    return torch.logsumexp(v, dim=_dims(v, axis), keepdim=keepdims)


def _reduction(name, fn, has_dtype=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        ax = _norm_axis(axis)
        if has_dtype and dtype is not None:
            d = canonical_dtype(dtype)
            return apply(lambda v: fn(v.to(d), ax, keepdim),
                         _t(x), op_name=name_)
        return apply(lambda v: fn(v, ax, keepdim), _t(x), op_name=name_)
    name_ = name
    op.__name__ = name
    return op


sum = _reduction("sum", _sum, has_dtype=True)
mean = _reduction("mean", _mean, has_dtype=True)
prod = _reduction("prod", _prod, has_dtype=True)
max = _reduction("max", _amax)
min = _reduction("min", _amin)
amax = max
amin = min
all = _reduction("all", _all)
any = _reduction("any", _any)
logsumexp = _reduction("logsumexp", _logsumexp)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    ddof = 1 if unbiased else 0
    return apply(lambda v: torch.std(v, dim=_dims(v, ax), correction=ddof,
                                     keepdim=keepdim),
                 _t(x), op_name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    ddof = 1 if unbiased else 0
    return apply(lambda v: torch.var(v, dim=_dims(v, ax), correction=ddof,
                                     keepdim=keepdim),
                 _t(x), op_name="var")


def _arg(fn, v, axis, keepdim, d):
    if axis is None:
        out = fn(v.reshape(-1), dim=0)
        if keepdim:
            out = out.reshape([1] * v.dim())
    else:
        out = fn(v, dim=axis, keepdim=keepdim)
    return out.to(d)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = canonical_dtype(dtype)
    return apply(lambda v: _arg(torch.argmax, v, axis, keepdim, d),
                 _t(x), op_name="argmax")


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = canonical_dtype(dtype)
    return apply(lambda v: _arg(torch.argmin, v, axis, keepdim, d),
                 _t(x), op_name="argmin")


def cumsum(x, axis=None, dtype=None, name=None):
    def fn(v):
        if axis is None:
            v = v.reshape(-1)
            return torch.cumsum(v, 0, dtype=canonical_dtype(dtype))
        return torch.cumsum(v, axis, dtype=canonical_dtype(dtype))
    return apply(fn, _t(x), op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    def fn(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0, dtype=canonical_dtype(dtype))
        return torch.cumprod(v, dim, dtype=canonical_dtype(dtype))
    return apply(fn, _t(x), op_name="cumprod")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply(lambda v: torch.sum((v != 0).to(torch.int32), dim=_dims(v, ax),
                                     keepdim=keepdim),
                 _t(x), op_name="count_nonzero")


def _quantile(v, q, axis, keepdims, nan=False):
    """jnp.quantile's linear interpolation (jnp.median: q = 0.5, the mean
    of the two middle values of an even count); ``nan``: NaNs ignored."""
    if not v.dtype.is_floating_point:
        v = v.to(torch.get_default_dtype())
    f = torch.nanquantile if nan else torch.quantile
    if axis is None:
        out = f(v.reshape(-1), q, dim=0)
        return out.reshape([1] * v.dim()) if keepdims else out
    return f(v, q, dim=axis, keepdim=keepdims)


def median(x, axis=None, keepdim=False, name=None):
    return apply(lambda v: _quantile(v, 0.5, axis, keepdim),
                 _t(x), op_name="median")


def quantile(x, q, axis=None, keepdim=False, name=None):
    return apply(lambda v: _quantile(v, q, axis, keepdim),
                 _t(x), op_name="quantile")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(v):
        idx = torch.argsort(v, dim=axis, stable=True)
        sorted_v = torch.gather(v, axis, idx)
        vals = torch.select(sorted_v, axis, k - 1)
        inds = torch.select(idx, axis, k - 1)
        if keepdim:
            vals = vals.unsqueeze(axis)
            inds = inds.unsqueeze(axis)
        return vals, inds.to(canonical_dtype("int64"))
    return apply(fn, _t(x), op_name="kthvalue")


# ---------------------------------------------------------------------------
# matmul / linalg
# ---------------------------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x:
            a = a.transpose(-1, -2) if a.dim() > 1 else a
        if transpose_y:
            b = b.transpose(-1, -2) if b.dim() > 1 else b
        return torch.matmul(a, b)
    return apply(fn, _t(x), _t(y), op_name="matmul")


mm = matmul


def bmm(x, y, name=None):
    return apply(torch.matmul, _t(x), _t(y), op_name="bmm")


def dot(x, y, name=None):
    return apply(lambda a, b: torch.sum(a * b, dim=-1), _t(x), _t(y), op_name="dot")


def outer(x, y, name=None):
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                 _t(x), _t(y), op_name="outer")


def _transpose_all(v):
    return v.permute(*reversed(range(v.dim())))


def t(x, name=None):
    return apply(_transpose_all, _t(x), op_name="t")


def einsum(equation, *operands):
    tensors = [_t(o) for o in operands]
    return apply(lambda *vs: torch.einsum(equation, *vs), *tensors, op_name="einsum")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)

    def fn(v):
        dims = _dims(v, ax)
        if p in ("fro", 2, 2.0):
            return torch.sqrt(torch.sum(torch.square(v), dim=dims, keepdim=keepdim))
        if p in (np.inf, "inf", float("inf")):
            return torch.amax(torch.abs(v), dim=dims, keepdim=keepdim)
        if p == 1:
            return torch.sum(torch.abs(v), dim=dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(v), p), dim=dims,
                                   keepdim=keepdim), 1.0 / p)

    return apply(fn, _t(x), op_name="norm")


def matmul_nt(x, y):
    """matmul(x, y.T) convenience used by parallel layers."""
    return matmul(x, y, transpose_y=True)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
def reshape(x, shape, name=None):
    shape = [int(s) for s in (shape.tolist() if isinstance(shape, (Tensor, np.ndarray)) else shape)]
    return apply(lambda v: torch.reshape(v, shape), _t(x), op_name="reshape")


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    return apply(lambda v: v.permute(*perm), _t(x), op_name="transpose")


def squeeze(x, axis=None, name=None):
    ax = _norm_axis(axis)
    if isinstance(ax, int):
        ax = (ax,)

    def fn(v):
        if ax is None:
            return torch.squeeze(v)
        keep = [a for a in ax if v.shape[a] == 1]
        return torch.squeeze(v, dim=tuple(keep)) if keep else v

    return apply(fn, _t(x), op_name="squeeze")


def unsqueeze(x, axis, name=None):
    ax = _norm_axis(axis)
    if isinstance(ax, int):
        ax = (ax,)

    def fn(v):
        for a in sorted(ax):
            v = torch.unsqueeze(v, a)
        return v
    return apply(fn, _t(x), op_name="unsqueeze")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(v):
        nd = v.dim()
        s = start_axis % nd if nd else 0
        e = stop_axis % nd if nd else 0
        new_shape = tuple(v.shape[:s]) + (-1,) + tuple(v.shape[e + 1:])
        return torch.reshape(v, new_shape)
    return apply(fn, _t(x), op_name="flatten")


def concat(x: Sequence, axis=0, name=None):
    tensors = [_t(e) for e in x]
    axis = int(unwrap(axis)) if isinstance(axis, Tensor) else int(axis)
    return apply(lambda *vs: torch.cat(vs, dim=axis), *tensors, op_name="concat")


def stack(x: Sequence, axis=0, name=None):
    tensors = [_t(e) for e in x]
    return apply(lambda *vs: torch.stack(vs, dim=axis), *tensors, op_name="stack")


def split(x, num_or_sections, axis=0, name=None):
    axis = int(unwrap(axis)) if isinstance(axis, Tensor) else int(axis)

    def fn(v):
        total = v.shape[axis]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(
                    f"array split does not result in an equal division: "
                    f"{total} into {num_or_sections}")
            return tuple(torch.split(v, total // num_or_sections, dim=axis))
        sections = list(num_or_sections)
        known = builtins.sum(s for s in sections if s != -1)
        sections = [s if s != -1 else total - known for s in sections]
        return tuple(torch.split(v, sections, dim=axis))

    return list(apply(fn, _t(x), op_name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0, name=None):
    return list(apply(lambda v: tuple(torch.unbind(v, dim=axis)),
                      _t(x), op_name="unbind"))


def tile(x, repeat_times, name=None):
    reps = [int(r) for r in repeat_times]
    return apply(lambda v: torch.tile(v, reps), _t(x), op_name="tile")


def expand(x, shape, name=None):
    shape = [int(s) for s in shape]

    def fn(v):
        tgt = list(shape)
        src = list(v.shape)
        # paddle expand: -1 keeps dim
        off = len(tgt) - len(src)
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = src[i - off] if i >= off else 1
        return torch.broadcast_to(v, tgt)

    return apply(fn, _t(x), op_name="expand")


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, _t(y).shape)


def flip(x, axis, name=None):
    ax = _norm_axis(axis)
    return apply(lambda v: torch.flip(v, dims=_dims(v, ax)), _t(x), op_name="flip")


def roll(x, shifts, axis=None, name=None):
    return apply(lambda v: torch.roll(v, shifts, dims=axis), _t(x), op_name="roll")


def repeat_interleave(x, repeats, axis=None, name=None):
    def fn(v):
        r = unwrap(repeats) if isinstance(repeats, Tensor) else repeats
        if isinstance(r, torch.Tensor):
            r = r.long()
        return torch.repeat_interleave(v, r, dim=axis)
    return apply(fn, _t(x), op_name="repeat_interleave")


def tril(x, diagonal=0, name=None):
    return apply(lambda v: torch.tril(v, diagonal), _t(x), op_name="tril")


def triu(x, diagonal=0, name=None):
    return apply(lambda v: torch.triu(v, diagonal), _t(x), op_name="triu")


def diag(x, offset=0, padding_value=0, name=None):
    def fn(v):
        if v.dim() == 1:
            out = torch.diag(v, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(v), offset) == 0
                out = torch.where(mask, padding_value, out)
            return out
        return torch.diagonal(v, offset)
    return apply(fn, _t(x), op_name="diag")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda v: torch.diagonal(v, offset, axis1, axis2),
                 _t(x), op_name="diagonal")


def kron(x, y, name=None):
    return apply(torch.kron, _t(x), _t(y), op_name="kron")


def moveaxis(x, source, destination, name=None):
    return apply(lambda v: torch.movedim(v, source, destination), _t(x), op_name="moveaxis")


def as_strided(x, shape, stride, offset=0, name=None):
    raise NotImplementedError(
        "as_strided is not part of the Paddle surface the JAX package "
        "gives (it raises there too); use reshape/slice ops")


# ---------------------------------------------------------------------------
# indexing / search
# ---------------------------------------------------------------------------
def _take(v, i, axis):
    """jnp.take(v, i, axis): the rows ``i`` (any shape) along ``axis``."""
    axis = axis % v.dim()
    out = torch.index_select(v, axis, i.reshape(-1).long())
    return out.reshape(tuple(v.shape[:axis]) + tuple(i.shape)
                       + tuple(v.shape[axis + 1:]))


def gather(x, index, axis=0, name=None):
    return apply(lambda v, i: _take(v, i, axis), _t(x), _t(index), op_name="gather")


def _nd_index(idx):
    return tuple(idx.long().movedim(-1, 0))


def gather_nd(x, index, name=None):
    return apply(lambda v, idx: v[_nd_index(idx)], _t(x), _t(index),
                 op_name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(v, i, u):
        return v.index_put((i.long(),), u.to(v.dtype), accumulate=not overwrite)
    return apply(fn, _t(x), _t(index), _t(updates), op_name="scatter")


def scatter_nd_add(x, index, updates, name=None):
    def fn(v, i, u):
        return v.index_put(_nd_index(i), u.to(v.dtype), accumulate=True)
    return apply(fn, _t(x), _t(index), _t(updates), op_name="scatter_nd_add")


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def index_sample(x, index):
    return apply(lambda v, i: torch.gather(v, 1, i.long()),
                 _t(x), _t(index), op_name="index_sample")


def take_along_axis(arr, indices, axis, name=None):
    return apply(lambda v, i: torch.take_along_dim(v, i.long(), dim=axis),
                 _t(arr), _t(indices), op_name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def fn(v, i, u):
        i = i.long()
        u = torch.broadcast_to(u.to(v.dtype), i.shape)
        if reduce == "add":
            return torch.scatter_add(v, axis, i, u)
        if reduce == "multiply":
            return torch.scatter_reduce(v, axis, i, u, "prod")
        return torch.scatter(v, axis, i, u)
    return apply(fn, _t(arr), _t(indices), _t(values), op_name="put_along_axis")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return apply(lambda c, a, b: torch.where(c.bool(), a, b), _t(condition),
                 _t(x), _t(y), op_name="where")


def nonzero(x, as_tuple=False):
    # data-dependent output shape: one read back (the reference's host op)
    nz = torch.nonzero(unwrap(_t(x)))
    if as_tuple:
        return tuple(Tensor(z) for z in nz.unbind(-1))
    return Tensor(nz)


def masked_select(x, mask, name=None):
    v = unwrap(_t(x)).detach()
    m = unwrap(_t(mask)).bool()
    return Tensor(v[m])


def masked_fill(x, mask, value, name=None):
    val = unwrap(value) if isinstance(value, Tensor) else value
    return apply(lambda v, m: torch.where(m.bool(), val, v), _t(x), _t(mask),
                 op_name="masked_fill")


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    def fn(v):
        vals, idx = torch.topk(v, k, dim=axis, largest=largest, sorted=True)
        return vals, idx.to(canonical_dtype("int64"))
    return apply(fn, _t(x), op_name="topk")


def sort(x, axis=-1, descending=False, name=None):
    def fn(v):
        s = torch.sort(v, dim=axis, stable=True).values
        return torch.flip(s, dims=(axis,)) if descending else s
    return apply(fn, _t(x), op_name="sort")


def argsort(x, axis=-1, descending=False, name=None):
    def fn(v):
        i = torch.argsort(v, dim=axis, stable=True)
        i = torch.flip(i, dims=(axis,)) if descending else i
        return i.to(canonical_dtype("int64"))
    return apply(fn, _t(x), op_name="argsort")


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    return apply(lambda s, v: torch.searchsorted(s, v, right=right).to(
        canonical_dtype("int64")),
                 _t(sorted_sequence), _t(values), op_name="searchsorted")


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    t = _t(x)
    v = t.numpy()
    res = np.unique(v, return_index=return_index, return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = t._value.device
    if isinstance(res, tuple):
        return tuple(Tensor(torch.from_numpy(np.asarray(r)).to(dev)) for r in res)
    return Tensor(torch.from_numpy(res).to(dev))


def one_hot(x, num_classes, name=None):
    return apply(lambda v: torch.nn.functional.one_hot(
        v.long(), num_classes).to(torch.get_default_dtype()),
                 _t(x), op_name="one_hot")


def bincount(x, weights=None, minlength=0, name=None):
    if weights is not None:
        return apply(lambda v, w: torch.bincount(v.long(), w, minlength=minlength),
                     _t(x), _t(weights), op_name="bincount")
    return Tensor(torch.bincount(unwrap(_t(x)).long(), minlength=minlength))


# ---------------------------------------------------------------------------
# comparisons returning scalars / misc
# ---------------------------------------------------------------------------
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                                            equal_nan=equal_nan).all(),
                 _t(x), _t(y), op_name="allclose")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                                            equal_nan=equal_nan),
                 _t(x), _t(y), op_name="isclose")


def _array_equal(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return torch.eq(a, b).all()


def equal_all(x, y, name=None):
    return apply(_array_equal, _t(x), _t(y), op_name="equal_all")


def cast(x, dtype):
    return _t(x).astype(dtype)


def increment(x, value=1.0, name=None):
    out = apply(lambda v: v + value, _t(x), op_name="increment")
    if isinstance(x, Tensor):
        x._replace(out)
        return x
    return out


def assign(x, output=None):
    src = _t(x)
    out = apply(lambda v: v.clone(), src, op_name="assign")
    if output is not None:
        output._replace(out)
        return output
    return out


def numel(x, name=None):
    t = _t(x)
    return Tensor(torch.tensor(t.size, device=t._value.device))


def shape(x):
    t = _t(x)
    return Tensor(torch.tensor(t.shape, dtype=torch.int32, device=t._value.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


# ---------------------------------------------------------------------------
# install Tensor methods + operators
# ---------------------------------------------------------------------------
_METHODS = dict(
    add=add, subtract=subtract, multiply=multiply, divide=divide, pow=pow,
    matmul=matmul, mm=mm, bmm=bmm, dot=dot, t=t, floor_divide=floor_divide,
    remainder=remainder, mod=mod, maximum=maximum, minimum=minimum,
    exp=exp, log=log, sqrt=sqrt, rsqrt=rsqrt, abs=abs, floor=floor, ceil=ceil,
    round=round, sin=sin, cos=cos, tan=tan, tanh=tanh, sigmoid=sigmoid, erf=erf,
    square=square, sign=sign, reciprocal=reciprocal, isnan=isnan, isinf=isinf,
    isfinite=isfinite, scale=scale, clip=clip, lerp=lerp,
    sum=sum, mean=mean, prod=prod, max=max, min=min, all=all, any=any,
    logsumexp=logsumexp, std=std, var=var, argmax=argmax, argmin=argmin,
    cumsum=cumsum, cumprod=cumprod, median=median,
    reshape=reshape, transpose=transpose, squeeze=squeeze, unsqueeze=unsqueeze,
    flatten=flatten, split=split, chunk=chunk, unbind=unbind, tile=tile,
    expand=expand, expand_as=expand_as, broadcast_to=broadcast_to, flip=flip,
    roll=roll, repeat_interleave=repeat_interleave, tril=tril, triu=triu,
    gather=gather, gather_nd=gather_nd, scatter=scatter, index_select=index_select,
    take_along_axis=take_along_axis, put_along_axis=put_along_axis,
    masked_fill=masked_fill, masked_select=masked_select, where=where,
    nonzero=nonzero, topk=topk, sort=sort, argsort=argsort, unique=unique,
    allclose=allclose, isclose=isclose, equal_all=equal_all, equal=equal,
    not_equal=not_equal, greater_than=greater_than, greater_equal=greater_equal,
    less_than=less_than, less_equal=less_equal, logical_and=logical_and,
    logical_or=logical_or, logical_xor=logical_xor, logical_not=logical_not,
    norm=norm, one_hot=one_hot, moveaxis=moveaxis, diagonal=diagonal,
    count_nonzero=count_nonzero, kthvalue=kthvalue, bincount=bincount,
)

for _name, _fn in _METHODS.items():
    setattr(Tensor, _name, _fn)

Tensor.__add__ = lambda self, o: add(self, o)
Tensor.__radd__ = lambda self, o: add(o, self)
Tensor.__sub__ = lambda self, o: subtract(self, o)
Tensor.__rsub__ = lambda self, o: subtract(o, self)
Tensor.__mul__ = lambda self, o: multiply(self, o)
Tensor.__rmul__ = lambda self, o: multiply(o, self)
Tensor.__truediv__ = lambda self, o: divide(self, o)
Tensor.__rtruediv__ = lambda self, o: divide(o, self)
Tensor.__floordiv__ = lambda self, o: floor_divide(self, o)
Tensor.__mod__ = lambda self, o: remainder(self, o)
Tensor.__pow__ = lambda self, o: pow(self, o)
Tensor.__rpow__ = lambda self, o: pow(o, self)
Tensor.__matmul__ = lambda self, o: matmul(self, o)
Tensor.__neg__ = lambda self: neg(self)
Tensor.__abs__ = lambda self: abs(self)
Tensor.__invert__ = lambda self: logical_not(self)
Tensor.__eq__ = lambda self, o: equal(self, o)
Tensor.__ne__ = lambda self, o: not_equal(self, o)
Tensor.__gt__ = lambda self, o: greater_than(self, o)
Tensor.__ge__ = lambda self, o: greater_equal(self, o)
Tensor.__lt__ = lambda self, o: less_than(self, o)
Tensor.__le__ = lambda self, o: less_equal(self, o)
Tensor.__and__ = lambda self, o: logical_and(self, o)
Tensor.__or__ = lambda self, o: logical_or(self, o)
Tensor.__xor__ = lambda self, o: logical_xor(self, o)
