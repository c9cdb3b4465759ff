"""Single-source op schema — counterpart of ``paddle_tpu/core/op_schema.py``.

The JAX package's table carries, per op, the implementation and its test
matrix (numpy ``oracle``, ``sample`` generator, dtypes, tolerances,
gradient check). The port keeps the table's shape and, per spec, the
torch implementation ``fn``; :func:`install` makes a Paddle-shaped
public wrapper (through ``dispatch.apply``, so AMP, the nan/inf scan and
the profiler apply) for every spec the namespace does not define by
hand. The reference's ``oracle``, ``sample``, dtypes and tolerances stay
the test oracle (``tests/test_torch_op_schema.py`` drives the port's ops
from the reference's table).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from .dispatch import apply
from .math_ops import _dims, _nd_index as _nd, _quantile, _take

# per-dtype default relative tolerances (the reference's)
DEFAULT_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}


@dataclass
class OpSpec:
    name: str
    fn: Callable                        # torch impl: fn(*tensors, **attrs)
    oracle: Optional[Callable] = None   # the reference's table holds these
    sample: Optional[Callable] = None
    dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    tol: Dict[str, float] = field(default_factory=dict)
    atol: float = 1e-6
    grad: bool = True
    grad_arg: int = 0
    n_outputs: int = 1
    integer_inputs: Tuple[int, ...] = ()

    def tolerance(self, dtype: str) -> float:
        return self.tol.get(dtype, DEFAULT_TOL.get(dtype, 1e-5))


OPS: Dict[str, OpSpec] = {}


def register(spec: OpSpec) -> OpSpec:
    assert spec.name not in OPS, f"duplicate op spec {spec.name}"
    OPS[spec.name] = spec
    return spec


def make_public(spec: OpSpec) -> Callable:
    """Public paddle-shaped wrapper for a spec (Tensor in/out, dispatch
    funnel for AMP/nan-inf/profiler)."""

    def op(*args, **attrs):
        attrs.pop("name", None)
        return apply(functools.partial(spec.fn, **attrs), *args,
                     op_name=spec.name)

    op.__name__ = spec.name
    op.__qualname__ = spec.name
    op.__doc__ = (f"``{spec.name}`` — generated from the single-source op "
                  "schema (core/op_schema.py).")
    return op


def install(namespace: dict, only_missing: bool = True) -> list:
    """Install public wrappers for every registered spec into ``namespace``
    (e.g. the package's module dict). Returns the installed names."""
    added = []
    for name, spec in OPS.items():
        if only_missing and name in namespace and namespace[name] is not None:
            continue
        namespace[name] = make_public(spec)
        added.append(name)
    return added


def _reg(name, fn, **kw):
    register(OpSpec(name=name, fn=fn, **kw))


def _along(v, axis, s, e):
    return torch.narrow(v, axis, s, e - s)


# ---------------------------------------------------------------------------
# specs — the reference's table, in its order
# ---------------------------------------------------------------------------
def _segment(reduce):
    def fn(data, ids, num_segments):
        idx = ids.long()
        shape = (num_segments,) + tuple(data.shape[1:])
        expand = idx.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
        ones = torch.ones_like(idx, dtype=torch.float32)
        cnt = torch.zeros(num_segments, dtype=torch.float32,
                          device=data.device).index_add(0, idx, ones)
        bshape = (-1,) + (1,) * (data.dim() - 1)
        if reduce in ("sum", "mean"):
            s = torch.zeros(shape, dtype=data.dtype,
                            device=data.device).index_add(0, idx, data)
            if reduce == "sum":
                return s
            return s / torch.clamp_min(cnt, 1.0).reshape(bshape)
        init = torch.full(shape, float("-inf") if reduce == "max" else float("inf"),
                          dtype=data.dtype, device=data.device)
        out = init.scatter_reduce(0, expand, data,
                                  "amax" if reduce == "max" else "amin")
        return torch.where((cnt > 0).reshape(bshape), out, 0.0).to(data.dtype)
    return fn


for _red in ("sum", "mean", "max", "min"):
    _reg(f"segment_{_red}", _segment(_red), integer_inputs=(1,),
         grad=_red in ("sum", "mean"), tol={"bfloat16": 4e-2})


def _index_add(x, index, value, axis=0):
    return x.index_add(axis % x.dim(), index.long(), value.to(x.dtype))


_reg("index_add", _index_add, integer_inputs=(1,))
_reg("trace", lambda x, offset=0, axis1=0, axis2=1: torch.sum(
    torch.diagonal(x, offset, axis1, axis2), dim=-1))
_reg("nanmedian", lambda x, axis=None, keepdim=False: _quantile(
    x, 0.5, axis, keepdim, nan=True), grad=False)


def _histogram(x, bins=100, min=0.0, max=0.0):
    if min == 0.0 and max == 0.0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float32,
                           device=x.device)
    xf = x.to(torch.float32)
    idx = torch.searchsorted(edges, xf.contiguous(), right=True) - 1
    idx = torch.where(xf == edges[-1], bins - 1, idx)
    keep = (xf >= edges[0]) & (xf <= edges[-1])
    return torch.bincount(idx[keep].long(), minlength=bins)[:bins].to(torch.int32)


_reg("histogram", _histogram, dtypes=("float32",), grad=False)
_reg("bucketize", lambda x, sorted_sequence, out_int32=False, right=False:
     torch.searchsorted(sorted_sequence.contiguous(), x.contiguous(),
                        right=right).to(torch.int32),
     dtypes=("float32",), grad=False)
_reg("rot90", lambda x, k=1, axes=(0, 1): torch.rot90(x, k, tuple(axes)))
_reg("diff", lambda x, n=1, axis=-1: torch.diff(x, n=n, dim=axis))
_reg("logcumsumexp", lambda x, axis=-1: torch.logcumsumexp(x, dim=axis),
     tol={"bfloat16": 5e-2})


def _renorm(x, p=2.0, axis=0, max_norm=1.0):
    ax = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x.to(torch.float32)) ** p, dim=ax,
                      keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    return (x * factor).to(x.dtype)


_reg("renorm", _renorm)
_reg("logaddexp", torch.logaddexp)
_reg("hypot", torch.hypot)
_reg("copysign", torch.copysign, grad=False)
_reg("frexp", lambda x: tuple(torch.frexp(x)), dtypes=("float32",), grad=False,
     n_outputs=2)
_reg("ldexp", lambda x, y: x * torch.pow(2.0, y.to(x.dtype)), dtypes=("float32",),
     integer_inputs=(1,), grad=False)


def _vander(x, n=None, increasing=False):
    n = x.shape[0] if n is None else n
    powers = range(n) if increasing else range(n - 1, -1, -1)
    return torch.stack([x ** p for p in powers], dim=-1)


_reg("vander", _vander, dtypes=("float32",))

# --- elementwise / special functions ---------------------------------------
for _name, _tf, _grad in [
    ("heaviside", lambda x, y: torch.heaviside(x, y.to(x.dtype)), False),
    ("nextafter", torch.nextafter, False),
    ("i0", lambda x: torch.special.i0(x), False),
    ("sinc", torch.sinc, True),
    ("signbit", torch.signbit, False),
    ("deg2rad", torch.deg2rad, True),
    ("rad2deg", torch.rad2deg, True),
    ("xlogy", lambda x, y: torch.where(x == 0, 0.0, x * torch.log(y)), True),
    ("logit", lambda x, eps=1e-6: torch.log(
        torch.clamp(x, eps, 1 - eps) / (1 - torch.clamp(x, eps, 1 - eps))), True),
    ("nansum", lambda x, axis=None, keepdim=False: torch.nansum(
        x, dim=_dims(x, axis), keepdim=keepdim), False),
    ("nanmean", lambda x, axis=None, keepdim=False: torch.nanmean(
        x, dim=_dims(x, axis), keepdim=keepdim), False),
]:
    _reg(_name, _tf, grad=_grad,
         dtypes=("float32",) if _name in ("nextafter", "signbit", "i0")
         else ("float32", "bfloat16"))


# --- integer ops ------------------------------------------------------------
for _name, _tf in [
    ("gcd", torch.gcd),
    ("lcm", torch.lcm),
    ("bitwise_left_shift", torch.bitwise_left_shift),
    ("bitwise_right_shift", torch.bitwise_right_shift),
]:
    _reg(_name, _tf, dtypes=("int32",), integer_inputs=(0, 1), grad=False)


# --- linalg-adjacent --------------------------------------------------------
_reg("addmm", lambda input, x, y, beta=1.0, alpha=1.0:
     beta * input + alpha * (x @ y), tol={"bfloat16": 5e-2})
_reg("cross", lambda x, y, axis=-1: torch.linalg.cross(x, y, dim=axis))


def _cdist(x, y, p=2.0):
    d = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    return torch.sum(d ** p, dim=-1) ** (1.0 / p)


_reg("cdist", _cdist, tol={"bfloat16": 5e-2})


def _pdist(x, p=2.0):
    r, c = torch.triu_indices(x.shape[0], x.shape[0], 1, device=x.device)
    return _cdist(x, x, p)[r, c]


_reg("pdist", _pdist, tol={"bfloat16": 5e-2})
_reg("clip_by_norm", lambda x, max_norm: x * torch.clamp(
    max_norm / (torch.sqrt(torch.sum(x.to(torch.float32) ** 2)) + 1e-12),
    max=1.0).to(x.dtype))
_reg("block_diag", lambda *xs: torch.block_diag(*xs))


# --- indexing ---------------------------------------------------------------
def _take_flat(x, index, mode="raise"):
    n = x.numel()
    idx = index.long()
    if mode == "raise":
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(
                f"take: index out of range for {n} elements "
                f"(min {lo}, max {hi}); use mode='wrap' or 'clip'")
        mode = "wrap"
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    return x.reshape(-1)[idx]


_reg("take", _take_flat, integer_inputs=(1,))


def _index_fill(x, index, axis, value):
    return x.index_fill(axis % x.dim(), index.long(), value)


_reg("index_fill", _index_fill, integer_inputs=(1,))
_reg("triu_indices", lambda row, col=None, offset=0: torch.triu_indices(
    row, col or row, offset).to(torch.int32), dtypes=("float32",), grad=False)
_reg("tril_indices", lambda row, col=None, offset=0: torch.tril_indices(
    row, col or row, offset).to(torch.int32), dtypes=("float32",), grad=False)


# --- batch 4: tensor-API audit gaps -----------------------------------------
_reg("as_complex", lambda x: torch.complex(x[..., 0], x[..., 1]),
     dtypes=("float32",), grad=False)
_reg("as_real", lambda x: torch.stack([x.real, x.imag], dim=-1),
     dtypes=("complex64",), integer_inputs=(0,), grad=False)


def _diagflat(x, offset=0):
    return torch.diagflat(x, offset)


_reg("diagflat", _diagflat)


def _dist(x, y, p=2.0):
    d = torch.abs(x - y).to(torch.float32)
    if p == float("inf"):
        return torch.amax(d)
    if p == 0:
        return torch.sum((d != 0).to(torch.float32))
    return torch.sum(d ** p) ** (1.0 / p)


_reg("dist", _dist)
_reg("inner", torch.inner, tol={"bfloat16": 5e-2})
_reg("mv", torch.matmul, tol={"bfloat16": 5e-2})
_reg("nan_to_num", lambda x, nan=0.0, posinf=None, neginf=None:
     torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf),
     dtypes=("float32",), grad=False)
_reg("nanquantile", lambda x, q, axis=None, keepdim=False: _quantile(
    x, q, axis, keepdim, nan=True), dtypes=("float32",), grad=False)
_reg("polar", lambda abs, angle: torch.polar(abs, angle),
     dtypes=("float32",), grad=False)
_reg("sgn", torch.sgn, grad=False)
_reg("stanh", lambda x, scale_a=0.67, scale_b=1.7159:
     scale_b * torch.tanh(scale_a * x))
_reg("tensordot", lambda x, y, axes=2: torch.tensordot(x, y, dims=axes),
     tol={"bfloat16": 5e-2})
_reg("unflatten", lambda x, axis, shape: torch.unflatten(
    x, axis % x.dim(), tuple(shape)))


def _cumext(op):
    def fn(x, axis=-1):
        f = torch.cummax if op == "max" else torch.cummin
        vals, idx = f(x, dim=axis % x.dim())
        return vals, idx.to(torch.int32)
    return fn


for _op in ("max", "min"):
    _reg(f"cum{_op}", _cumext(_op), n_outputs=2, grad=False)


def _scatter_nd(index, updates, shape):
    out = torch.zeros(tuple(shape), dtype=updates.dtype, device=updates.device)
    return out.index_put(_nd(index), updates, accumulate=True)


_reg("scatter_nd", _scatter_nd, integer_inputs=(0,), grad_arg=1)
_reg("pixel_unshuffle", lambda x, downscale_factor, data_format="NCHW":
     torch.nn.functional.pixel_unshuffle(x, downscale_factor))

# --- complex ops (FFT companions) -------------------------------------------
for _name, _tf in [
    ("angle", torch.angle),
    ("conj", lambda x: torch.conj(x).resolve_conj()),
    ("real", lambda x: x.real.clone()),
    ("imag", lambda x: x.imag.clone()),
]:
    _reg(_name, _tf, dtypes=("complex64",), integer_inputs=(0,), grad=False)

# --- more special functions -------------------------------------------------
_reg("i0e", torch.special.i0e, dtypes=("float32",), grad=False)
_reg("i1", torch.special.i1, dtypes=("float32",), grad=False)
_reg("polygamma", lambda x, n=1: torch.special.polygamma(n, x),
     dtypes=("float32",), tol={"float32": 1e-3}, grad=False)


def _combinations(x, r=2, with_replacement=False):
    n = x.shape[0]
    idx = list(itertools.combinations_with_replacement(range(n), r)
               if with_replacement else itertools.combinations(range(n), r))
    return x[torch.tensor(idx, dtype=torch.long, device=x.device)]


_reg("combinations", _combinations, dtypes=("float32",), grad=False)
_reg("channel_shuffle", lambda x, groups, data_format="NCHW": x.reshape(
    x.shape[0], groups, x.shape[1] // groups, *x.shape[2:]).transpose(
        1, 2).reshape(x.shape))


# ===========================================================================
# the mechanical op families (the hand-written public ops keep theirs:
# ``install(only_missing=True)``; these specs mirror the reference's table)
# ===========================================================================
for _name, _tf in [
    ("abs", torch.abs), ("cos", torch.cos), ("sin", torch.sin),
    ("tan", torch.tan), ("cosh", torch.cosh), ("sinh", torch.sinh),
    ("tanh", torch.tanh), ("exp", torch.exp), ("expm1", torch.expm1),
    ("sigmoid", torch.sigmoid), ("neg", torch.neg), ("square", torch.square),
    ("sqrt", torch.sqrt), ("rsqrt", torch.rsqrt),
    ("reciprocal", torch.reciprocal), ("log", torch.log), ("log2", torch.log2),
    ("log10", torch.log10), ("log1p", torch.log1p), ("erf", torch.erf),
    ("acos", torch.acos), ("asin", torch.asin), ("atan", torch.atan),
    ("acosh", torch.acosh), ("asinh", torch.asinh), ("atanh", torch.atanh),
]:
    _reg(_name, _tf, tol={"bfloat16": 4e-2})

for _name, _tf in [("ceil", torch.ceil), ("floor", torch.floor),
                   ("round", torch.round), ("trunc", torch.trunc),
                   ("sign", torch.sign)]:
    _reg(_name, _tf, grad=False)

for _name, _tf in [("erfinv", torch.erfinv), ("digamma", torch.digamma),
                   ("lgamma", torch.lgamma)]:
    _reg(_name, _tf, dtypes=("float32",), tol={"float32": 1e-4})

for _name, _tf, _grad in [
    ("add", torch.add, True), ("subtract", torch.subtract, True),
    ("multiply", torch.multiply, True), ("divide", torch.divide, True),
    ("maximum", torch.maximum, True), ("minimum", torch.minimum, True),
    ("fmax", torch.fmax, True), ("fmin", torch.fmin, True),
    ("atan2", torch.atan2, True), ("pow", torch.pow, True),
    ("mod", torch.remainder, False), ("remainder", torch.remainder, False),
    ("floor_divide", torch.floor_divide, False),
    ("floor_mod", torch.remainder, False),
]:
    _reg(_name, _tf, grad=_grad, tol={"bfloat16": 4e-2})

_reg("lerp", lambda x, y, weight: x + weight * (y - x))
_reg("scale", lambda x, scale=1.0, bias=0.0, bias_after_scale=True:
     x * scale + bias if bias_after_scale else (x + bias) * scale)
_reg("increment", lambda x, value=1.0: x + value, grad=False)
_reg("clip", lambda x, min=None, max=None: torch.clamp(x, min, max), grad=False)

for _name, _tf in [
    ("equal", torch.eq), ("not_equal", torch.ne),
    ("greater_than", torch.gt), ("greater_equal", torch.ge),
    ("less_than", torch.lt), ("less_equal", torch.le),
    ("logical_and", torch.logical_and), ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor), ("logical_not", torch.logical_not),
    ("isfinite", torch.isfinite), ("isinf", torch.isinf),
    ("isnan", torch.isnan),
    ("isclose", lambda x, y, **kw: torch.isclose(x, y, **kw)),
    ("allclose", lambda x, y, **kw: torch.isclose(x, y, **kw).all()),
]:
    _reg(_name, _tf, dtypes=("float32",), grad=False)

for _name, _tf in [("bitwise_and", torch.bitwise_and),
                   ("bitwise_or", torch.bitwise_or),
                   ("bitwise_xor", torch.bitwise_xor),
                   ("bitwise_not", torch.bitwise_not)]:
    _reg(_name, _tf, dtypes=("int32",), integer_inputs=(0, 1), grad=False)


def _reducer(f):
    return lambda x, axis=None, keepdim=False: f(x, dim=_dims(x, axis),
                                                 keepdim=keepdim)


def _prod(x, axis=None, keepdim=False):
    for d in sorted(_dims(x, axis), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _arg(f):
    def fn(x, axis=None, keepdim=False):
        if axis is None:
            return f(x.reshape(-1), dim=0).to(torch.int32)
        return f(x, dim=axis).to(torch.int32)
    return fn


def _cumsum(x, axis=None):
    return torch.cumsum(x.reshape(-1), 0) if axis is None \
        else torch.cumsum(x, axis)


for _name, _tf, _grad in [
    ("sum", _reducer(torch.sum), True),
    ("mean", _reducer(torch.mean), True),
    ("prod", _prod, True),
    ("max", _reducer(torch.amax), False),
    ("min", _reducer(torch.amin), False),
    ("amax", _reducer(torch.amax), False),
    ("amin", _reducer(torch.amin), False),
    ("logsumexp", _reducer(torch.logsumexp), True),
    ("count_nonzero", lambda x, axis=None, keepdim=False: torch.sum(
        (x != 0).to(torch.int32), dim=_dims(x, axis), keepdim=keepdim), False),
    ("argmax", _arg(torch.argmax), False),
    ("argmin", _arg(torch.argmin), False),
    ("cumsum", _cumsum, True),
    ("median", lambda x, axis=None, keepdim=False: _quantile(
        x, 0.5, axis, keepdim), False),
    ("quantile", lambda x, q, axis=None, keepdim=False: _quantile(
        x, q, axis, keepdim), False),
]:
    _reg(_name, _tf, grad=_grad,
         dtypes=("float32", "bfloat16")
         if _name in ("sum", "mean", "max", "min", "amax", "amin")
         else ("float32",), tol={"bfloat16": 5e-2})

_reg("cumprod", lambda x, dim=None: torch.cumprod(x.reshape(-1), 0)
     if dim is None else torch.cumprod(x, dim), dtypes=("float32",))

for _name in ("std", "var"):
    _reg(_name, (lambda f: lambda x, axis=None, unbiased=True, keepdim=False:
                 f(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                   keepdim=keepdim))(torch.std if _name == "std" else torch.var),
         dtypes=("float32",))


def _norm(x, p="fro", axis=None, keepdim=False):
    if p == "fro":
        return torch.linalg.norm(x, dim=axis, keepdim=keepdim)
    return torch.linalg.norm(x, ord=p, dim=axis, keepdim=keepdim)


_reg("norm", _norm, dtypes=("float32",))


def _kth(x, k, axis=-1, keepdim=False):
    idx = torch.argsort(x, dim=axis, stable=True)
    return (torch.select(torch.gather(x, axis, idx), axis, k - 1),
            torch.select(idx, axis, k - 1).to(torch.int32))


_reg("kthvalue", _kth, dtypes=("float32",), grad=False, n_outputs=2)


def _squeeze(x, axis=None):
    return torch.squeeze(x) if axis is None else torch.squeeze(x, axis)


def _flatten(x, start_axis=0, stop_axis=-1):
    return x.reshape(tuple(x.shape[:start_axis]) + (-1,)
                     + tuple(x.shape[(stop_axis % x.dim()) + 1:]))


def _diag(x, offset=0, padding_value=0):
    return torch.diag(x, offset)


for _name, _tf in [
    ("reshape", lambda x, shape: torch.reshape(x, tuple(shape))),
    ("transpose", lambda x, perm: x.permute(*perm)),
    ("squeeze", _squeeze),
    ("unsqueeze", lambda x, axis: torch.unsqueeze(x, axis)),
    ("flatten", _flatten),
    ("flip", lambda x, axis: torch.flip(x, _dims(x, axis))),
    ("roll", lambda x, shifts, axis=None: torch.roll(x, shifts, axis)),
    ("tile", lambda x, repeat_times: torch.tile(x, tuple(repeat_times))),
    ("broadcast_to", lambda x, shape: torch.broadcast_to(x, tuple(shape))),
    ("expand", lambda x, shape: torch.broadcast_to(x, tuple(shape))),
    ("moveaxis", lambda x, source, destination: torch.movedim(
        x, source, destination)),
    ("t", lambda x: x.permute(*reversed(range(x.dim())))),
    ("tril", lambda x, diagonal=0: torch.tril(x, diagonal)),
    ("triu", lambda x, diagonal=0: torch.triu(x, diagonal)),
    ("diag", _diag),
    ("diagonal", lambda x, offset=0, axis1=0, axis2=1: torch.diagonal(
        x, offset, axis1, axis2)),
    ("diag_embed", lambda x, offset=0, dim1=-2, dim2=-1: torch.diag_embed(
        x, offset)),
]:
    _reg(_name, _tf, tol={"bfloat16": 4e-2})

for _name, _tf in [
    ("dot", lambda x, y: torch.sum(x * y, dim=-1)),
    ("outer", lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1))),
    ("kron", torch.kron), ("bmm", torch.matmul), ("mm", torch.matmul),
    ("matmul", torch.matmul),
]:
    _reg(_name, _tf, tol={"bfloat16": 5e-2})

_reg("einsum", lambda equation, *ops: torch.einsum(equation, *ops),
     integer_inputs=(0,), grad=False, tol={"bfloat16": 5e-2})

# --- indexing / selection ---------------------------------------------------
_reg("gather", lambda x, index, axis=0: _take(x, index, axis),
     integer_inputs=(1,))
_reg("index_select", lambda x, index, axis=0: _take(x, index, axis),
     integer_inputs=(1,))
_reg("gather_nd", lambda x, index: x[_nd(index)], integer_inputs=(1,))
_reg("take_along_axis", lambda arr, indices, axis: torch.take_along_dim(
    arr, indices.long(), dim=axis), integer_inputs=(1,))


def _put_along_axis(arr, indices, values, axis, reduce="assign"):
    if reduce != "assign":
        raise NotImplementedError(
            f"put_along_axis: reduce={reduce!r} not supported")
    return torch.scatter(arr, axis, indices.long(),
                         torch.broadcast_to(values.to(arr.dtype), indices.shape))


_reg("put_along_axis", _put_along_axis, integer_inputs=(1,), grad_arg=0)
_reg("index_sample", lambda x, index: torch.gather(x, 1, index.long()),
     integer_inputs=(1,))
_reg("scatter", lambda x, index, updates, overwrite=True: x.index_put(
    (index.long(),), updates.to(x.dtype), accumulate=not overwrite),
     integer_inputs=(1,), grad_arg=0)
_reg("scatter_nd_add", lambda x, index, updates: x.index_put(
    _nd(index), updates.to(x.dtype), accumulate=True),
     integer_inputs=(1,), grad_arg=0)
_reg("masked_fill", lambda x, mask, value: torch.where(mask.bool(), value, x),
     integer_inputs=(1,), grad_arg=0)
_reg("masked_select", lambda x, mask: x[mask.bool()], integer_inputs=(1,),
     grad=False)
_reg("where", lambda condition, x=None, y=None: torch.where(
    condition.bool(), x, y), integer_inputs=(0,), grad_arg=1)
_reg("one_hot", lambda x, num_classes: torch.nn.functional.one_hot(
    x.long(), num_classes).to(torch.float32),
     dtypes=("float32",), integer_inputs=(0,), grad=False)


def _topk(x, k, axis=-1, largest=True, sorted=True):
    v, i = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return v, i.to(torch.int32)


_reg("topk", _topk, dtypes=("float32",), grad=False, n_outputs=2)


def _sort(x, axis=-1, descending=False):
    s = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(s, (axis,)) if descending else s


_reg("sort", _sort, grad=False)
_reg("argsort", lambda x, axis=-1, descending=False: torch.argsort(
    -x if descending else x, dim=axis, stable=True).to(torch.int32),
     dtypes=("float32",), grad=False)
_reg("searchsorted", lambda sorted_sequence, values, out_int32=False,
     right=False: torch.searchsorted(sorted_sequence.contiguous(),
                                     values.contiguous(),
                                     right=right).to(torch.int32),
     dtypes=("float32",), grad=False)
_reg("bincount", lambda x, weights=None, minlength=0: torch.bincount(
    x.long(), weights, minlength).to(torch.int32 if weights is None
                                     else weights.dtype),
     dtypes=("int32",), integer_inputs=(0,), grad=False)
_reg("repeat_interleave", lambda x, repeats, axis=None: torch.repeat_interleave(
    x, repeats, dim=axis))


def _shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(input, size, rounding_mode="floor") == shard_id,
                       torch.remainder(input, size),
                       torch.full_like(input, ignore_value))


_reg("shard_index", _shard_index, dtypes=("int32",), integer_inputs=(0,),
     grad=False)


# --- integration family -----------------------------------------------------
def _spacing(y, x, dx, ax):
    if x is None:
        return dx
    d = torch.diff(x, dim=ax if x.dim() > 1 else -1)
    if x.dim() == 1 and y.dim() > 1:
        shape = [1] * y.dim()
        shape[ax] = d.shape[0]
        d = d.reshape(shape)
    return d


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    ax = axis % y.dim()
    n = y.shape[ax]
    lo, hi = _along(y, ax, 0, n - 1), _along(y, ax, 1, n)
    return torch.sum((lo + hi) * 0.5 * _spacing(y, x, dx, ax), dim=ax)


def _cumulative_trapezoid(y, x=None, dx=1.0, axis=-1):
    ax = axis % y.dim()
    n = y.shape[ax]
    lo, hi = _along(y, ax, 0, n - 1), _along(y, ax, 1, n)
    return torch.cumsum((lo + hi) * 0.5 * _spacing(y, x, dx, ax), dim=ax)


_reg("trapezoid", _trapezoid)
_reg("cumulative_trapezoid", _cumulative_trapezoid)

# --- the elementwise long tail ----------------------------------------------
_reg("i1e", torch.special.i1e, dtypes=("float32",), grad=False)
_reg("multigammaln", lambda x, p=2: torch.special.multigammaln(x, p),
     dtypes=("float32",), grad=False)
_reg("isneginf", torch.isneginf, dtypes=("float32",), grad=False)
_reg("isposinf", torch.isposinf, dtypes=("float32",), grad=False)
_reg("isreal", torch.isreal, dtypes=("complex64",), integer_inputs=(0,),
     grad=False)
_reg("positive", torch.positive, dtypes=("float32", "float64", "int32"))
_reg("negative", torch.negative, dtypes=("float32", "float64", "int32"))
_reg("float_power", lambda x, y: torch.float_power(x, y).to(x.dtype),
     dtypes=("float32",), grad=False)
