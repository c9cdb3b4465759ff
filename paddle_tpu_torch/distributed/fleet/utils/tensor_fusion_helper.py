"""Gradient fusion buffers for bucketed communication — counterpart of
``paddle_tpu/distributed/fleet/utils/tensor_fusion_helper.py``.

Many small per-parameter collectives become a few collectives on flat
buffers: :func:`fused_parameters` packs the parameters in order into
buckets of about ``group_size`` bytes, and a :class:`FusedCommBuffer`
copies each gradient into its slice of one flat buffer, runs one
collective on it and writes the slices back.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

ALIGN = 128  # flat-buffer slice alignment, in elements


def _aligned(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def id_of(p) -> int:
    return id(p)


def _numel(p) -> int:
    return int(np.prod(tuple(p.shape))) if len(p.shape) else 1


def _value(g):
    return g._value if hasattr(g, "_value") else g


class FusedCommBuffer:
    """One flat buffer holding a bucket of gradients (fp32 with
    ``use_main_grad``, else the first gradient's dtype).

    ``add_grad`` packs a parameter's gradient into its slice; once every
    parameter has contributed, ``comm`` runs the collective on the flat
    buffer (by default the sum over ``comm_group``) and
    ``scatter_grads`` writes the slices back into each ``grad`` (or
    ``main_grad``)."""

    def __init__(self, id: int, params: Sequence, comm_group=None,
                 acc_steps: int = 1, use_main_grad: bool = False):
        self._id = id
        self._params = list(params)
        self._group = comm_group
        self._use_main_grad = use_main_grad
        self._offsets = {}
        off = 0
        for p in self._params:
            n = _numel(p)
            self._offsets[id_of(p)] = (off, n)
            off += _aligned(n)
        self._numel = off
        self._dtype = torch.float32 if use_main_grad else None
        self.buffer = None
        self._pending = set(id_of(p) for p in self._params)

    def add_grad(self, param) -> None:
        g = param.main_grad if self._use_main_grad else param.grad
        assert g is not None, "param has no grad to fuse"
        v = _value(g)
        if self.buffer is None:
            self.buffer = torch.zeros(self._numel,
                                      dtype=self._dtype or v.dtype,
                                      device=v.device)
        off, n = self._offsets[id_of(param)]
        with torch.no_grad():
            self.buffer[off:off + n].copy_(v.reshape(-1))
        self._pending.discard(id_of(param))

    @property
    def all_grads_added(self) -> bool:
        return not self._pending

    def comm(self, collective_fn: Optional[Callable] = None) -> None:
        """``collective_fn(buffer) -> buffer``, else the sum of every
        rank's buffer over the group (each rank holds the gradients of
        its own batch; the reference's one controller sums ``nranks``
        copies of one buffer, the same formula)."""
        assert self.all_grads_added, "bucket incomplete"
        if collective_fn is not None:
            self.buffer = collective_fn(self.buffer)
            return
        from ... import collective as C
        self.buffer = C.all_reduce_replicated(self.buffer, group=self._group)

    def scatter_grads(self) -> None:
        """Write the reduced slices back into each parameter's
        ``grad`` (or fp32 ``main_grad``)."""
        with torch.no_grad():
            for p in self._params:
                off, n = self._offsets[id_of(p)]
                sl = self.buffer[off:off + n].reshape(tuple(p.shape))
                if self._use_main_grad:
                    p.main_grad = sl.float().clone()
                else:
                    p.grad = sl.to(_value(p).dtype).clone()
        self._pending = set(id_of(p) for p in self._params)


def fused_parameters(parameters: Sequence, group_size: int = 128 * 1024 * 1024,
                     comm_group=None, use_main_grad: bool = False,
                     dtype_bytes: int = 4) -> List[FusedCommBuffer]:
    """The parameters in order, in buckets of about ``group_size``
    bytes (128 MB by default, the reference's), one
    :class:`FusedCommBuffer` each."""
    buffers: List[FusedCommBuffer] = []
    bucket: List = []
    acc = 0
    for p in parameters:
        sz = _aligned(_numel(p)) * dtype_bytes
        if bucket and acc + sz > group_size:
            buffers.append(FusedCommBuffer(len(buffers), bucket, comm_group,
                                           use_main_grad=use_main_grad))
            bucket, acc = [], 0
        bucket.append(p)
        acc += sz
    if bucket:
        buffers.append(FusedCommBuffer(len(buffers), bucket, comm_group,
                                       use_main_grad=use_main_grad))
    return buffers
