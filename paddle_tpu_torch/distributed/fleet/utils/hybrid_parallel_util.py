"""Gradient and parameter sync of hybrid parallelism — counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.

Each rank holds the gradients of its own batch: the fused all-reduce
over the data-parallel (or sharding) group, divided by the group's size,
gives every rank the gradient of the global mean, and the broadcasts
make replicas start from the same values (the group's first rank's).
The reference's one controller sums ``nranks`` copies of one gradient
and divides the same way, and its broadcasts are no-ops.
"""

from __future__ import annotations

from typing import Sequence

from ... import collective as C
from .tensor_fusion_helper import fused_parameters


def fused_allreduce_gradients(parameter_list: Sequence, hcg=None,
                              group=None, scale=None,
                              use_main_grad: bool = False) -> None:
    """Bucketed all-reduce of every parameter's gradient over the dp
    group (``group``, else ``hcg``'s), divided by ``scale`` (the group
    size by default). Expert parameters (``expert``) are skipped."""
    params = [p for p in parameter_list if not getattr(p, "expert", False)]
    attr = "main_grad" if use_main_grad else "grad"
    params = [p for p in params if getattr(p, attr, None) is not None]
    if not params:
        return
    if group is None and hcg is not None:
        group = hcg.get_data_parallel_group()
    if group is None or getattr(group, "nranks", 1) <= 1:
        return
    if scale is None:
        scale = float(group.nranks)
    for buf in fused_parameters(params, comm_group=group,
                                use_main_grad=use_main_grad):
        for p in buf._params:
            buf.add_grad(p)
        buf.comm()
        if scale != 1.0:
            buf.buffer = buf.buffer / scale
        buf.scatter_grads()


def _src_of(group) -> int:
    return group.ranks[0]


def broadcast_input_data(hcg, *inputs, **kwargs):
    """The mp group's first rank's inputs on every rank of the group
    (in place), returned as given."""
    g = hcg.get_model_parallel_group() if hcg is not None else None
    if g is not None and g.nranks > 1:
        for v in list(inputs) + list(kwargs.values()):
            if hasattr(v, "shape"):
                C.broadcast(v, src=_src_of(g), group=g)
    if kwargs:
        return list(inputs) + [kwargs]
    return inputs if len(inputs) != 1 else inputs[0]


def _broadcast_params(model, group) -> None:
    if group is None or group.nranks <= 1:
        return
    for p in model.parameters():
        C.broadcast(p, src=_src_of(group), group=group)


def broadcast_mp_parameters(model, hcg) -> None:
    """Every mp rank's replicated (not mp-split) parameters from the mp
    group's first rank."""
    g = hcg.get_model_parallel_group()
    if g is None or g.nranks <= 1:
        return
    for p in model.parameters():
        if not getattr(p, "is_distributed", False):
            C.broadcast(p, src=_src_of(g), group=g)


def broadcast_dp_parameters(model, hcg) -> None:
    """The dp replicas' parameters from the dp group's first rank."""
    _broadcast_params(model, hcg.get_data_parallel_group())


def broadcast_sharding_parameters(model, hcg) -> None:
    """The sharding replicas' parameters from the group's first rank."""
    _broadcast_params(model, hcg.get_sharding_parallel_group())


def sharding_reduce_gradients(parameter_list: Sequence, hcg) -> None:
    """The gradients averaged over the sharding group (stage 1)."""
    group = hcg.get_sharding_parallel_group() if hcg is not None else None
    if group is None or getattr(group, "nranks", 1) <= 1:
        return
    fused_allreduce_gradients(parameter_list, group=group,
                              scale=float(group.nranks))
