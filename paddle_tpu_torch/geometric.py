"""``paddle.geometric`` — graph message passing and segment ops,
counterpart of ``paddle_tpu/geometric.py``.

The compute ops are a gather and a scatter-reduce (``index_add`` for sums
and counts, ``scatter_reduce`` for min and max), so they differentiate;
an empty segment gives the reference's value, 0 for every reduction. The
two sampling utilities run on the host in numpy, as the reference's do
(their output sizes depend on the data); ``sample_neighbors`` draws from
numpy's global generator exactly as the reference does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.dispatch import apply
from .core.tensor import Tensor

__all__ = [
    "send_u_recv", "send_ue_recv", "send_uv",
    "segment_sum", "segment_mean", "segment_min", "segment_max",
    "reindex_graph", "sample_neighbors",
]

_MSG_OPS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
}


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _seg_reduce(msgs, dst, n, reduce_op: str):
    """Reduce the rows of ``msgs`` into ``n`` segments by ``dst``
    (``jax.ops.segment_*``: ids outside [0, n) are dropped)."""
    keep = (dst >= 0) & (dst < n)
    if not bool(keep.all()):
        msgs, dst = msgs[keep], dst[keep]
    out_shape = (n,) + tuple(msgs.shape[1:])
    bshape = (-1,) + (1,) * (msgs.dim() - 1)
    if reduce_op == "sum":
        return msgs.new_zeros(out_shape).index_add(0, dst, msgs)
    if reduce_op == "mean":
        tot = msgs.new_zeros(out_shape).index_add(0, dst, msgs)
        cnt = msgs.new_zeros(n).index_add(
            0, dst, torch.ones(msgs.shape[0], dtype=msgs.dtype,
                               device=msgs.device))
        return tot / torch.clamp_min(cnt, 1.0).reshape(bshape)
    if reduce_op in ("min", "max"):
        idx = dst.reshape(bshape).expand_as(msgs)
        out = msgs.new_zeros(out_shape).scatter_reduce(
            0, idx, msgs, reduce="amin" if reduce_op == "min" else "amax",
            include_self=False)
        # an empty segment holds 0 for every dtype, as the reference
        # masks its reduction identity by count
        cnt = torch.zeros(n, dtype=torch.int32, device=msgs.device).index_add(
            0, dst, torch.ones(msgs.shape[0], dtype=torch.int32,
                               device=msgs.device))
        return torch.where((cnt > 0).reshape(bshape), out,
                           torch.zeros((), dtype=msgs.dtype,
                                       device=msgs.device))
    raise ValueError(f"unknown reduce_op {reduce_op!r}; "
                     "pick from sum/mean/min/max")


def _out_size(dst, out_size):
    if out_size is not None:
        return int(out_size)
    if dst.numel() == 0:
        return 0
    return int(dst.max()) + 1


def send_u_recv(x, src_index, dst_index, reduce_op: str = "sum",
                out_size: Optional[int] = None, name=None):
    """Gather the rows of ``x`` at ``src_index`` and reduce them at
    ``dst_index`` (graph_send_recv); ``out_size=None`` is max(dst) + 1."""

    def fn(xv, src, dst):
        n = _out_size(dst, out_size)
        return _seg_reduce(xv[src.long()], dst.long(), n, reduce_op)
    return apply(fn, _t(x), _t(src_index), _t(dst_index),
                 op_name="send_u_recv")


def send_ue_recv(x, y, src_index, dst_index, message_op: str = "add",
                 reduce_op: str = "sum", out_size: Optional[int] = None,
                 name=None):
    """Node features combined with edge features
    (``message_op(x[src], y_edge)``), then reduced at dst."""
    if message_op not in _MSG_OPS:
        raise ValueError(f"unknown message_op {message_op!r}")

    def fn(xv, yv, src, dst):
        n = _out_size(dst, out_size)
        msgs = _MSG_OPS[message_op](xv[src.long()], yv)
        return _seg_reduce(msgs, dst.long(), n, reduce_op)
    return apply(fn, _t(x), _t(y), _t(src_index), _t(dst_index),
                 op_name="send_ue_recv")


def send_uv(x, y, src_index, dst_index, message_op: str = "add", name=None):
    """Edge messages ``message_op(x[src], y[dst])``, not reduced
    (graph_send_uv)."""
    if message_op not in _MSG_OPS:
        raise ValueError(f"unknown message_op {message_op!r}")

    def fn(xv, yv, src, dst):
        return _MSG_OPS[message_op](xv[src.long()], yv[dst.long()])
    return apply(fn, _t(x), _t(y), _t(src_index), _t(dst_index),
                 op_name="send_uv")


def _segment(data, segment_ids, reduce_op):
    def fn(d, s):
        n = _out_size(s, None)
        return _seg_reduce(d, s.long(), n, reduce_op)
    return apply(fn, _t(data), _t(segment_ids),
                 op_name=f"segment_{reduce_op}")


def segment_sum(data, segment_ids, name=None):
    """paddle.geometric.segment_sum (the ids may come in any order)."""
    return _segment(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    return _segment(data, segment_ids, "mean")


def segment_min(data, segment_ids, name=None):
    return _segment(data, segment_ids, "min")


def segment_max(data, segment_ids, name=None):
    return _segment(data, segment_ids, "max")


def _host(x):
    if isinstance(x, Tensor):
        x = x._value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(a, ref):
    """A host result as a Tensor where ``ref`` lives (the current place
    for host input)."""
    v = ref._value if isinstance(ref, Tensor) else ref
    dev = v.device if isinstance(v, torch.Tensor) else None
    return Tensor(torch.as_tensor(a, device=dev) if dev is not None else a)


def reindex_graph(x, neighbors, count, name=None):
    """Host-side graph reindexing (graph_reindex): the node ids of ``x``
    (the unique targets) and ``neighbors`` (the concatenated neighbour
    lists, their lengths in ``count``) mapped to 0..n-1. Returns
    (reindex_src, reindex_dst, out_nodes)."""
    xv, nb, cnt = _host(x), _host(neighbors), _host(count)
    order = {int(v): i for i, v in enumerate(xv)}
    out_nodes = list(xv)
    for v in nb:
        v = int(v)
        if v not in order:
            order[v] = len(out_nodes)
            out_nodes.append(v)
    reindex_src = np.asarray([order[int(v)] for v in nb], np.int32)
    reindex_dst = np.repeat(np.arange(len(cnt), dtype=np.int32), cnt)
    return (_like(reindex_src, x), _like(reindex_dst, x),
            _like(np.asarray(out_nodes, np.int32), x))


def sample_neighbors(row, colptr, input_nodes, sample_size: int = -1,
                     eids=None, return_eids: bool = False,
                     perm_buffer=None, name=None):
    """Host-side uniform neighbour sampling over a CSC graph
    (graph_sample_neighbors): (out_neighbors, out_count). The draws are
    the reference's: a ``RandomState`` seeded from numpy's global
    generator, ``choice`` without replacement per node."""
    if return_eids or eids is not None:
        raise NotImplementedError(
            "sample_neighbors eids tracking is not implemented; sample "
            "without eids or index edge features by (dst, position)")
    rowv, colv, nodes = _host(row), _host(colptr), _host(input_nodes)
    rng = np.random.RandomState(np.random.randint(0, 2 ** 31))
    outs, counts = [], []
    for n in nodes:
        lo, hi = int(colv[n]), int(colv[n + 1])
        neigh = rowv[lo:hi]
        if sample_size >= 0 and len(neigh) > sample_size:
            neigh = rng.choice(neigh, size=sample_size, replace=False)
        outs.append(neigh)
        counts.append(len(neigh))
    flat = np.concatenate(outs) if outs else np.zeros((0,), rowv.dtype)
    return (_like(flat.astype(np.int32), row),
            _like(np.asarray(counts, np.int32), row))
