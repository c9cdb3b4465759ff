"""Tensor-API surface that does not fit the single-source op schema:
list/tuple outputs, host-side results, predicates and random ops —
counterpart of ``paddle_tpu/core/extra_ops.py``, the same functions over
torch. The random ops draw from the framework key stream
(``paddle_tpu_torch.random``)."""

from __future__ import annotations

import builtins
from typing import List, Sequence

import numpy as np
import torch

from .. import random as _random
from .dispatch import apply
from .dtype import convert_dtype
from .tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _v(x):
    return x._value if isinstance(x, Tensor) else _t(x)._value


# -- predicates / introspection ---------------------------------------------
def is_complex(x) -> bool:
    return _v(x).dtype.is_complex


def is_floating_point(x) -> bool:
    return _v(x).dtype.is_floating_point


def is_empty(x) -> Tensor:
    v = _v(x)
    return Tensor(torch.tensor(v.numel() == 0, device=v.device))


def rank(x) -> Tensor:
    v = _v(x)
    return Tensor(torch.tensor(v.dim(), dtype=torch.int32, device=v.device))


def tolist(x) -> list:
    return _t(x).tolist()


def broadcast_shape(x_shape, y_shape) -> List[int]:
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


# -- copies / views ----------------------------------------------------------
def clone(x) -> Tensor:
    """Differentiable copy (paddle.clone — delegates to Tensor.clone)."""
    return _t(x).clone()


def hstack(x, name=None) -> Tensor:
    """paddle.hstack: takes a LIST/tuple of tensors (concat along dim 1,
    or dim 0 for 1-D inputs — numpy hstack semantics)."""
    ts = [_t(t) for t in x]
    return apply(lambda *vs: torch.hstack(vs), *ts, op_name="hstack")


def view(x, shape_or_dtype):
    """paddle.view: reshape view (or dtype reinterpret for a dtype arg)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return apply(lambda v: v.reshape(tuple(
            int(s) for s in shape_or_dtype)), _t(x), op_name="view")
    return apply(lambda v: v.view(convert_dtype(shape_or_dtype)), _t(x),
                 op_name="view_dtype")


def broadcast_tensors(inputs: Sequence) -> List[Tensor]:
    vals = [_v(i) for i in inputs]
    shape = torch.broadcast_shapes(*[v.shape for v in vals])
    return [apply(lambda v, s=shape: torch.broadcast_to(v, s), _t(i),
                  op_name="broadcast_tensors") for i in inputs]


# -- splits / stacks ---------------------------------------------------------
def unstack(x, axis=0, num=None) -> List[Tensor]:
    v = _v(x)
    n = num or v.shape[axis]
    return [apply(lambda a, i=i: torch.select(a, axis, i), _t(x),
                  op_name="unstack") for i in range(n)]


def _nsplit(x, num_or_sections, axis):
    from .math_ops import split
    return split(_t(x), num_or_sections, axis=axis)


def hsplit(x, num_or_sections):
    v = _v(x)
    return _nsplit(x, num_or_sections, 0 if v.dim() == 1 else 1)


def vsplit(x, num_or_sections):
    return _nsplit(x, num_or_sections, 0)


def dsplit(x, num_or_sections):
    return _nsplit(x, num_or_sections, 2)


# -- indexing ---------------------------------------------------------------
def slice(x, axes, starts, ends) -> Tensor:  # noqa: A001 — paddle name
    """paddle.slice: static slice along the given axes."""
    def fn(v):
        idx = [builtins.slice(None)] * v.dim()
        for ax, s, e in zip(axes, starts, ends):
            dim = v.shape[ax]
            s = int(s) if s >= 0 else int(s) + dim
            e = int(e) if e >= 0 else int(e) + dim
            idx[ax] = builtins.slice(max(s, 0), min(e, dim))
        return v[tuple(idx)]

    return apply(fn, _t(x), op_name="slice")


def shard_index(input, index_num: int, nshards: int, shard_id: int,
                ignore_value: int = -1) -> Tensor:
    """paddle.shard_index: a global index as its shard-local value,
    ``ignore_value`` for indices other shards own."""
    size = (index_num + nshards - 1) // nshards

    def fn(v):
        owner = torch.div(v, size, rounding_mode="floor")
        local = torch.remainder(v, size)
        return torch.where(owner == shard_id, local,
                           torch.full_like(v, ignore_value))

    return apply(fn, _t(input), op_name="shard_index")


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Host-side op: the output length depends on the data."""
    t = _t(x)
    dev = t._value.device
    v = t.numpy()
    moved = False
    if axis is None:
        v = v.reshape(-1)
    elif axis % v.ndim != 0:
        v = np.moveaxis(v, axis, 0)  # dedupe runs along the given axis
        moved = True
    keep = np.ones(v.shape[0], bool)
    if v.shape[0] > 1:
        if v.ndim == 1:
            keep[1:] = v[1:] != v[:-1]
        else:
            keep[1:] = np.any(v[1:] != v[:-1],
                              axis=tuple(range(1, v.ndim)))
    kept = v[keep]
    if moved:
        kept = np.moveaxis(kept, 0, axis)

    def out_t(a):
        return Tensor(torch.from_numpy(np.ascontiguousarray(a)).to(dev))

    res = [out_t(kept)]
    if return_inverse:
        res.append(out_t((np.cumsum(keep) - 1).astype(np.int32)))
    if return_counts:
        pos = np.flatnonzero(keep)
        res.append(out_t(np.diff(np.append(pos, v.shape[0])).astype(np.int32)))
    return res[0] if len(res) == 1 else tuple(res)


# -- linalg adjacent ---------------------------------------------------------
def inverse(x) -> Tensor:
    return apply(torch.linalg.inv, _t(x), op_name="inverse")


# -- random ------------------------------------------------------------------
def _generator(key: torch.Tensor, device) -> torch.Generator:
    """A torch generator seeded from a key of the framework stream (for
    the draws the port does not reproduce bit for bit)."""
    seed = int(_random.prng.bits(key, (2,)).cpu().prod() % (2 ** 63))
    return torch.Generator(device=device).manual_seed(seed)


def poisson(x) -> Tensor:
    """Element-wise Poisson sample with rate x (paddle.poisson). Seeded
    from the key stream; not the JAX package's bits."""
    key = _random.next_key()
    return apply(lambda v: torch.poisson(v, generator=_generator(key, v.device)).to(
        v.dtype), _t(x), op_name="poisson")


# -- round-4 API audit: stacks / splits / scatter views ----------------------
def vstack(x, name=None) -> Tensor:
    """paddle.vstack (row_stack): stack along dim 0, 1-D inputs become
    rows (numpy vstack semantics)."""
    return apply(lambda *vs: torch.vstack(vs), *[_t(t) for t in x],
                 op_name="vstack")


def row_stack(x, name=None) -> Tensor:
    return vstack(x, name)


def column_stack(x, name=None) -> Tensor:
    """paddle.column_stack: 1-D inputs become columns."""
    return apply(lambda *vs: torch.column_stack(vs), *[_t(t) for t in x],
                 op_name="column_stack")


def dstack(x, name=None) -> Tensor:
    return apply(lambda *vs: torch.dstack(vs), *[_t(t) for t in x],
                 op_name="dstack")


def _atleast(nd, inputs):
    f = {1: torch.atleast_1d, 2: torch.atleast_2d, 3: torch.atleast_3d}[nd]
    outs = [apply(lambda v, f=f: f(v), _t(t), op_name=f"atleast_{nd}d")
            for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(1, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(2, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(3, inputs)


def tensor_split(x, num_or_indices, axis=0, name=None) -> List[Tensor]:
    """paddle.tensor_split: like numpy array_split — uneven splits allowed
    for an int count; a list gives explicit cut indices."""
    v = _v(x)
    dim = v.shape[axis]
    if isinstance(num_or_indices, int):
        n = num_or_indices
        base, extra = divmod(dim, n)
        sizes = [base + (1 if i < extra else 0) for i in range(n)]
        cuts = np.cumsum([0] + sizes)
    else:
        idx = [int(i) for i in num_or_indices]
        cuts = np.asarray([0] + idx + [dim])
    outs = []
    for s, e in zip(cuts[:-1], cuts[1:]):
        outs.append(apply(
            lambda vv, s=int(s), e=int(e): torch.narrow(vv, axis, s, e - s),
            _t(x), op_name="tensor_split"))
    return outs


def mode(x, axis=-1, keepdim=False, name=None):
    """paddle.mode: the most frequent value (and its last index) along
    ``axis``; per-element counts from searchsorted over the sorted row,
    ties toward the largest index (the reference's algorithm)."""
    def fn(v):
        ax = axis % v.dim()
        mv = torch.movedim(v, ax, -1)
        lead = mv.shape[:-1]
        n = mv.shape[-1]
        flat = mv.reshape(-1, n).contiguous()
        sv = torch.sort(flat, dim=-1).values
        counts = (torch.searchsorted(sv, flat, right=True)
                  - torch.searchsorted(sv, flat, right=False))
        best = torch.amax(counts, dim=-1, keepdim=True)
        idx = torch.arange(n, device=v.device).expand_as(counts)
        pick = torch.amax(torch.where(counts == best, idx, -1), dim=-1)
        vals = torch.gather(flat, 1, pick[:, None])[:, 0].reshape(lead)
        pick = pick.reshape(lead)
        if keepdim:
            vals = vals.unsqueeze(ax)
            pick = pick.unsqueeze(ax)
        return vals, pick.to(torch.int32)

    return apply(fn, _t(x), op_name="mode", n_outputs=2)


def masked_scatter(x, mask, value, name=None) -> Tensor:
    """paddle.masked_scatter: fill True positions of ``mask`` with
    consecutive elements of ``value`` (row-major)."""
    def fn(v, m, val):
        mb = torch.broadcast_to(m.bool(), v.shape)
        k = torch.cumsum(mb.reshape(-1).long(), 0) - 1  # source index per slot
        src = val.reshape(-1)[k.clamp(min=0)].reshape(v.shape)
        return torch.where(mb, src.to(v.dtype), v)

    return apply(fn, _t(x), _t(mask), _t(value), op_name="masked_scatter")


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None) -> Tensor:
    """paddle.diagonal_scatter: write ``y`` (shaped like the diagonal
    view, diagonal length last) onto the selected diagonal."""
    return apply(lambda v, yv: torch.diagonal_scatter(
        v, yv.to(v.dtype), offset, axis1, axis2), _t(x), _t(y),
        op_name="diagonal_scatter")


def select_scatter(x, values, axis, index, name=None) -> Tensor:
    """paddle.select_scatter: write ``values`` into position ``index`` of
    dimension ``axis``."""
    return apply(lambda v, val: torch.select_scatter(
        v, val.to(v.dtype), axis, index), _t(x), _t(values),
        op_name="select_scatter")


def slice_scatter(x, value, axes, starts, ends, strides, name=None) -> Tensor:
    """paddle.slice_scatter: write ``value`` into the strided slice."""
    def fn(v, val):
        idx = [builtins.slice(None)] * v.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            idx[ax] = builtins.slice(int(s), int(e), int(st))
        out = v.clone()
        out[tuple(idx)] = val.to(v.dtype)
        return out

    return apply(fn, _t(x), _t(value), op_name="slice_scatter")


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """paddle.histogramdd: D-dimensional histogram of an (N, D) sample.
    Returns (hist, list_of_edges) — numpy.histogramdd semantics, binned
    on the device (searchsorted + bincount)."""
    v = _v(x)
    if v.dim() == 1:           # numpy promotes a 1-D sample to (N, 1)
        v = v[:, None]
    n_samples, ndim = v.shape
    w = None if weights is None else _v(weights)
    explicit = (isinstance(bins, (list, tuple)) and len(bins)
                and not np.isscalar(bins[0]))
    if explicit:
        edges = [_v(b).to(torch.float32) for b in bins]
        nbins = [int(e.shape[0]) - 1 for e in edges]
    elif np.isscalar(bins):
        nbins = [int(bins)] * ndim
    else:
        nbins = [int(b) for b in bins]
    if len(nbins) != ndim:
        raise ValueError(
            "The dimension of bins must be equal to the dimension of the "
            f"sample x ({len(nbins)} vs {ndim}).")
    if not explicit:
        if ranges is not None:
            r = list(ranges)
            lo = [float(np.float32(r[2 * i])) for i in range(ndim)]
            hi = [float(np.float32(r[2 * i + 1])) for i in range(ndim)]
        else:
            lo = [float(v[:, d].min()) for d in range(ndim)]
            hi = [float(v[:, d].max()) for d in range(ndim)]
            # a degenerate span widens to [lo-0.5, hi+0.5] (numpy)
            lo, hi = zip(*[(a - 0.5, b + 0.5) if a == b else (a, b)
                           for a, b in zip(lo, hi)])
        edges = [torch.linspace(lo[d], hi[d], nbins[d] + 1,
                                dtype=torch.float32, device=v.device)
                 for d in range(ndim)]

    flat_idx = torch.zeros((n_samples,), dtype=torch.int64, device=v.device)
    valid = torch.ones((n_samples,), dtype=torch.bool, device=v.device)
    for d in range(ndim):
        e = edges[d]
        col = v[:, d].to(e.dtype).contiguous()
        idx_d = torch.searchsorted(e, col, right=True) - 1
        # the rightmost bin is closed on both sides (numpy semantics)
        idx_d = torch.where(col == e[-1], nbins[d] - 1, idx_d)
        valid &= (col >= e[0]) & (col <= e[-1])
        idx_d = idx_d.clamp(0, nbins[d] - 1)
        flat_idx = flat_idx * nbins[d] + idx_d

    wv = valid.to(torch.float32) if w is None else torch.where(
        valid, w.to(torch.float32), 0.0)
    total = int(np.prod(nbins)) if nbins else 1
    hist = torch.bincount(flat_idx, weights=wv, minlength=total)
    hist = hist.reshape(tuple(nbins))
    if density:
        hist = hist / hist.sum()
        for d in range(ndim):
            shape = [1] * ndim
            shape[d] = nbins[d]
            hist = hist / torch.diff(edges[d]).reshape(shape)
    return (Tensor(hist.to(torch.float32)),
            [Tensor(e.to(torch.float32)) for e in edges])


# -- round-5 API-audit batch (sweep 4) ---------------------------------------
def frac(x, name=None) -> Tensor:
    """paddle.frac: x - trunc(x)."""
    return apply(lambda v: v - torch.trunc(v), _t(x), op_name="frac")


def gammaln(x, name=None) -> Tensor:
    """paddle.gammaln: log |Gamma(x)|."""
    return apply(lambda v: torch.lgamma(v.to(torch.float32)), _t(x),
                 op_name="gammaln")


def isin(x, test_x, assume_unique=False, invert=False, name=None) -> Tensor:
    """paddle.isin: elementwise membership of x in test_x."""
    return apply(lambda v, t: torch.isin(v, t, assume_unique=assume_unique,
                                         invert=invert),
                 _t(x), _t(test_x), op_name="isin")


def clip_(x, min=None, max=None, name=None) -> Tensor:
    """paddle.Tensor.clip_ (in place)."""
    t = _t(x)
    t._value = torch.clamp(t._value, min, max)
    return t


def geometric_(x, probs, name=None) -> Tensor:
    """paddle.Tensor.geometric_ (in place): fill with Geometric(probs)
    samples (Bernoulli trials to the first success, support 1..inf), from
    the key stream's uniform draw (the reference's formula)."""
    t = _t(x)
    key = _random.next_key()
    u = _random.uniform_draw(key, t._value.shape,
                             float(np.finfo(np.float32).tiny), 1.0,
                             device=t._value.device)
    p = probs._value if isinstance(probs, Tensor) else probs
    p = torch.as_tensor(p, dtype=torch.float32, device=u.device)
    g = torch.floor(torch.log(u) / torch.log1p(-p)) + 1.0
    t._value = g.to(t._value.dtype)
    return t


def index_put(x, indices, value, accumulate=False, name=None) -> Tensor:
    """paddle.index_put: out[indices] = value (``accumulate`` adds
    instead of overwriting)."""
    def fn(v, val, *idx):
        return v.index_put(tuple(i.long() for i in idx), val.to(v.dtype),
                           accumulate=accumulate)

    return apply(fn, _t(x), _t(value), *[_t(i) for i in indices],
                 op_name="index_put")


def index_put_(x, indices, value, accumulate=False, name=None) -> Tensor:
    t = _t(x)
    t._value = index_put(t, indices, value, accumulate)._value
    return t


def unfold(x, axis, size, step, name=None) -> Tensor:
    """paddle.Tensor.unfold: sliding windows of ``size`` every ``step``
    along ``axis``; the window dim is appended LAST (paddle semantics)."""
    return apply(lambda v: v.unfold(axis % v.dim(), size, step), _t(x),
                 op_name="unfold")
