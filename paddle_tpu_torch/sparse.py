"""``paddle.sparse`` — COO and CSR sparse tensors, counterpart of
``paddle_tpu/sparse.py``.

A sparse tensor is ``(indices, values)`` with the reference's static
``nnz``: coalescing keeps a fixed budget (merged slots keep one
representative, freed slots park at coordinate 0 with value 0), and the
products are a gather over the contraction index and a sum over the row
index (``index_add``), the reference's SelectedRows form. The indices
are int32 on the values' device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .core.dispatch import apply
from .core.tensor import Tensor


def _idx(x, device=None) -> torch.Tensor:
    if isinstance(x, Tensor):
        x = x._value
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int32)
    if device is None:
        from .core.place import current_place
        device = current_place().torch_device()
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def _vals(values) -> Tensor:
    return values if isinstance(values, Tensor) else Tensor(values)


def _strides(shape, sd: int, device) -> torch.Tensor:
    s = np.cumprod((1,) + tuple(shape[:sd])[::-1])[::-1][1:]
    return torch.as_tensor(np.ascontiguousarray(s), dtype=torch.int64,
                           device=device)


class SparseCooTensor:
    """COO sparse tensor: ``indices`` (sparse_ndim, nnz) int32, ``values``
    (nnz, *dense_dims), dense ``shape``. Duplicate coordinates are
    allowed and sum on densification (Paddle's behaviour before
    ``coalesce``)."""

    def __init__(self, indices, values, shape):
        self.values = _vals(values)
        self.indices = _idx(indices, self.values._value.device)
        self.shape = tuple(int(s) for s in shape)
        if self.indices.dim() != 2:
            raise ValueError("indices must be (sparse_ndim, nnz)")

    # -- introspection ------------------------------------------------------
    def nnz(self) -> int:
        return int(self.indices.shape[1])

    @property
    def dtype(self):
        return self.values.dtype

    def is_sparse_coo(self) -> bool:
        return True

    def is_sparse_csr(self) -> bool:
        return False

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")

    # -- conversions --------------------------------------------------------
    def _flat(self) -> torch.Tensor:
        sd = self.indices.shape[0]
        st = _strides(self.shape, sd, self.indices.device)
        return (self.indices.to(torch.int64) * st[:, None]).sum(dim=0)

    def to_dense(self) -> Tensor:
        shape = self.shape
        sd = self.indices.shape[0]
        flat_idx = self._flat()

        def fn(vals):
            flat_shape = (int(np.prod(shape[:sd])),) + tuple(shape[sd:])
            dense = vals.new_zeros(flat_shape).index_add(0, flat_idx, vals)
            return dense.reshape(shape)

        return apply(fn, self.values, op_name="sparse_to_dense")

    def coalesce(self, max_nnz: Optional[int] = None) -> "SparseCooTensor":
        """Merge duplicate coordinates at a static nnz: the distinct
        coordinates, sorted, take a prefix and the freed slots park at
        coordinate 0 with value 0 (``to_dense`` is unchanged). With
        ``max_nnz`` the result is cut to that budget, which is lossless
        when the distinct count fits (checked, else ValueError)."""
        sd = self.indices.shape[0]
        nnz = self.indices.shape[1]
        dev = self.indices.device
        flat = self._flat()
        uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
        distinct = uniq.shape[0]
        uniq = torch.cat([uniq, uniq.new_full((nnz - distinct,), -1)])
        v = self.values._value
        summed = v.new_zeros((nnz,) + tuple(v.shape[1:])).index_add(0, inv, v)
        keep = uniq >= 0
        safe = torch.where(keep, uniq, torch.zeros_like(uniq))
        st = _strides(self.shape, sd, dev)
        dims = torch.as_tensor(self.shape[:sd], dtype=torch.int64, device=dev)
        new_idx = (safe[None, :] // st[:, None]) % dims[:, None]
        vals = torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)),
                           summed, torch.zeros((), dtype=v.dtype, device=dev))
        out = SparseCooTensor(new_idx, Tensor(vals.detach().to(v.dtype)),
                              self.shape)
        if max_nnz is not None and max_nnz < out.nnz():
            if distinct > max_nnz:
                raise ValueError(
                    f"coalesce: {distinct} distinct coordinates exceed "
                    f"max_nnz={max_nnz}")
            out = SparseCooTensor(out.indices[:, :max_nnz],
                                  Tensor(out.values._value[:max_nnz]),
                                  self.shape)
        return out

    # -- math ---------------------------------------------------------------
    def __add__(self, other: "SparseCooTensor") -> "SparseCooTensor":
        """Sparse + sparse, coalesced and cut back to max(nnz_a, nnz_b)
        when the combined support fits (a repeated accumulation over a
        fixed support keeps a static nnz); disjoint supports keep
        nnz_a + nnz_b."""
        if not isinstance(other, SparseCooTensor):
            raise TypeError("sparse + dense: use to_dense() explicitly")
        if other.shape != self.shape:
            raise ValueError("shape mismatch")
        idx = torch.cat([self.indices, other.indices.to(self.indices.device)],
                        dim=1)
        vals = Tensor(torch.cat([self.values._value.detach(),
                                 other.values._value.detach()], dim=0))
        merged = SparseCooTensor(idx, vals, self.shape)
        budget = max(self.nnz(), other.nnz())
        try:
            return merged.coalesce(max_nnz=budget)
        except ValueError:  # the combined support is larger than either
            return merged.coalesce()

    def __mul__(self, scalar):
        return SparseCooTensor(self.indices, self.values * scalar, self.shape)

    __rmul__ = __mul__

    def matmul(self, dense) -> Tensor:
        """(M, K) sparse @ (K, N) dense -> (M, N) dense: the rows of
        ``dense`` gathered at the column coordinates, scaled by the
        values and summed at the row coordinates."""
        if len(self.shape) != 2 or self.indices.shape[0] != 2:
            raise ValueError("matmul needs a 2-D sparse matrix")
        m = self.shape[0]
        rows, cols = self.indices[0].long(), self.indices[1].long()

        def fn(vals, d):
            contrib = vals[:, None] * d[cols]            # (nnz, N)
            return contrib.new_zeros((m,) + tuple(d.shape[1:])).index_add(
                0, rows, contrib)

        return apply(fn, self.values,
                     dense if isinstance(dense, Tensor) else Tensor(dense),
                     op_name="sparse_matmul")

    def transpose(self, perm: Sequence[int]) -> "SparseCooTensor":
        perm = list(perm)
        return SparseCooTensor(self.indices[perm], self.values,
                               tuple(self.shape[p] for p in perm))


class SparseCsrTensor:
    """CSR sparse matrix: crows (M+1,), cols (nnz,), values (nnz,)."""

    def __init__(self, crows, cols, values, shape):
        self.values = _vals(values)
        dev = self.values._value.device
        self.crows = _idx(crows, dev)
        self.cols = _idx(cols, dev)
        self.shape = tuple(int(s) for s in shape)

    def nnz(self) -> int:
        return int(self.cols.shape[0])

    def is_sparse_csr(self) -> bool:
        return True

    def to_dense(self) -> Tensor:
        m, n = self.shape
        counts = (self.crows[1:] - self.crows[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(m, device=counts.device), counts,
            output_size=self.cols.shape[0])
        flat = rows * n + self.cols.long()

        def fn(vals):
            return vals.new_zeros(m * n).index_add(0, flat, vals).reshape(m, n)

        return apply(fn, self.values, op_name="sparse_csr_to_dense")


# -- constructors (paddle.sparse's names) -------------------------------------
def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True) -> SparseCooTensor:
    vals = _vals(values)
    if dtype is not None:
        vals = vals.astype(dtype)
    idx = _idx(indices, vals._value.device)
    if shape is None:
        shape = tuple(int(x) for x in idx.amax(dim=1).cpu().numpy() + 1)
    t = SparseCooTensor(idx, vals, shape)
    t.values.stop_gradient = stop_gradient
    return t


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      place=None, stop_gradient=True) -> SparseCsrTensor:
    vals = _vals(values)
    if dtype is not None:
        vals = vals.astype(dtype)
    return SparseCsrTensor(crows, cols, vals, shape)


def to_sparse_coo(dense: Tensor, sparse_dim: Optional[int] = None,
                  nnz: Optional[int] = None) -> SparseCooTensor:
    """Dense -> COO with a static nnz budget (the exact count by default,
    read on the host; ``nnz`` pads with coordinate-0, value-0 slots or
    cuts)."""
    t = dense._value if isinstance(dense, Tensor) else torch.as_tensor(dense)
    v = t.detach().cpu().numpy()
    sd = sparse_dim or v.ndim
    flat = v.reshape((-1,) + v.shape[sd:])
    mask = np.any(flat != 0, axis=tuple(range(1, flat.ndim))) \
        if flat.ndim > 1 else flat != 0
    pos = np.nonzero(mask)[0]
    pad = 0
    if nnz is not None:
        pos = pos[:nnz]
        pad = nnz - pos.size
        if pad > 0:
            pos = np.concatenate([pos, np.zeros(pad, pos.dtype)])
    idx = np.stack(np.unravel_index(pos, v.shape[:sd]))
    vals = flat[pos]
    if pad > 0:
        vals = vals.copy()
        vals[len(pos) - pad:] = 0
    return SparseCooTensor(torch.as_tensor(idx, dtype=torch.int32,
                                           device=t.device),
                           Tensor(torch.as_tensor(vals, device=t.device)),
                           v.shape)


# -- functional surface --------------------------------------------------------
def add(a: SparseCooTensor, b: SparseCooTensor) -> SparseCooTensor:
    return a + b


def matmul(a: SparseCooTensor, dense) -> Tensor:
    return a.matmul(dense)


def relu(a: SparseCooTensor) -> SparseCooTensor:
    from .nn import functional as F
    return SparseCooTensor(a.indices, F.relu(a.values), a.shape)


def is_sparse(x) -> bool:
    return isinstance(x, (SparseCooTensor, SparseCsrTensor))
