"""Megatron sequence parallelism (tied to tensor parallelism) —
counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``.

Activations outside the tensor-parallel regions (norms, dropout) are
split along the sequence dim over the mp group and re-partitioned at
the region's edges. Each rank holds its slice; the ops carry the
reference's gradients (its l.17-24):

=================  =======================  =========================
op                 forward                  backward
=================  =======================  =========================
ScatterOp          local seq slice          all-gather over seq
GatherOp           all-gather over seq      local seq slice
AllGatherOp        all-gather over seq      reduce-scatter
ReduceScatterOp    reduce-scatter           all-gather
=================  =======================  =========================

The reference runs them inside ``shard_map`` (its manual mode) and is
the identity elsewhere; here they act whenever the mp group has more
than one rank, and are the identity at degree 1. The ``*_array`` forms
take a torch tensor and a group or mesh axis name.
"""

from __future__ import annotations

import torch

from ... import collective as C
from ...meta_parallel.mp_layers import (  # noqa: F401  (re-export parity)
    ColumnParallelLinear, RowParallelLinear,
    mark_as_sequence_parallel_parameter, mp_group_of,
)

SEQ_AXIS = 0  # [s, b, h] layout, as in the reference


# ---------------------------------------------------------------------------
# array-level ops: a torch tensor and a group (or a mesh axis name)
# ---------------------------------------------------------------------------

def scatter_array(v, axis_name, dim: int = SEQ_AXIS):
    """This rank's slice of ``dim``; backward: all-gather."""
    return C.scatter_to_group(v, axis_name, dim)


def gather_array(v, axis_name, dim: int = SEQ_AXIS):
    """All-gather of ``dim``; backward: this rank's slice."""
    return C.gather_from_group(v, axis_name, dim)


def all_gather_array(v, axis_name, dim: int = SEQ_AXIS):
    """All-gather of ``dim``; backward: reduce-scatter."""
    return C.all_gather_grad(v, axis_name, dim)


def reduce_scatter_array(v, axis_name, dim: int = SEQ_AXIS):
    """Reduce-scatter of ``dim``; backward: all-gather."""
    return C.reduce_scatter_grad(v, axis_name, dim)


# ---------------------------------------------------------------------------
# Tensor-level ops (the reference's ScatterOp/GatherOp/... surface)
# ---------------------------------------------------------------------------

def _tensor_op(array_op, x, dim: int = SEQ_AXIS):
    g = mp_group_of(None)
    if g is None:
        return x
    return array_op(x, g, dim)


class ScatterOp:
    """Split the sequence dim over the mp ranks. bwd: all-gather."""

    @staticmethod
    def apply(x, axis: int = SEQ_AXIS):
        return _tensor_op(scatter_array, x, axis)


class GatherOp:
    """Assemble the whole sequence from the mp ranks. bwd: slice."""

    @staticmethod
    def apply(x, axis: int = SEQ_AXIS):
        return _tensor_op(gather_array, x, axis)


class AllGatherOp:
    """All-gather entering a tensor-parallel region. bwd:
    reduce-scatter."""

    @staticmethod
    def apply(x, axis: int = SEQ_AXIS):
        return _tensor_op(all_gather_array, x, axis)


class ReduceScatterOp:
    """Reduce-scatter leaving a tensor-parallel region. bwd:
    all-gather."""

    @staticmethod
    def apply(x, axis: int = SEQ_AXIS):
        return _tensor_op(reduce_scatter_array, x, axis)


# ---------------------------------------------------------------------------
# sequence-parallel linear layers
# ---------------------------------------------------------------------------

class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input is sequence-split: its
    forward all-gathers the sequence (backward: reduce-scatter, so the
    input's gradient comes back split) and multiplies by this rank's
    out-slab of the weight."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None, *, dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         gather_output, mp_group=mp_group, dtype=dtype,
                         device=device)

    def forward(self, x):
        from ....nn import functional as F
        g = self._group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(all_gather_array(x, g, SEQ_AXIS), self.weight,
                     self.bias)
        if self.gather_output:
            y = C.gather_from_group(y, g, dim=len(y.shape) - 1)
        return y


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output is sequence-split: the
    product with this rank's in-slab of the weight is reduce-scattered
    over the sequence (the row layer's all-reduce fused with the
    re-partition), then the whole bias is added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None, *, dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         input_is_parallel, mp_group=mp_group, dtype=dtype,
                         device=device)

    def forward(self, x):
        from ....nn import functional as F
        g = self._group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = C.scatter_to_group(x, g, dim=len(x.shape) - 1)
        y = reduce_scatter_array(F.linear(x, self.weight), g, SEQ_AXIS)
        return y if self.bias is None else y + self.bias


# ---------------------------------------------------------------------------
# gradient sync of the sequence-parallel parameters (norm weights etc.)
# ---------------------------------------------------------------------------

def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Record the parameters marked by
    ``mark_as_sequence_parallel_parameter``: their gradients come from
    sequence slices and are summed over the mp group by
    :func:`sequence_parallel_sync_gradients` after the backward."""
    marked = [p for p in model.parameters()
              if getattr(p, "is_sequence_parallel", False)]
    model._sequence_parallel_params = marked
    return marked


def sequence_parallel_sync_gradients(model, group=None):
    """Sum the marked parameters' gradients over the mp group (in
    place)."""
    g = group if group is not None else mp_group_of(None)
    params = getattr(model, "_sequence_parallel_params", None)
    if params is None:
        params = [p for p in model.parameters()
                  if getattr(p, "is_sequence_parallel", False)]
    if g is None:
        return
    for p in params:
        if p.grad is not None:
            C.all_reduce(p.grad, group=g)
