"""Counterpart of ``paddle_tpu/distributed/fleet``: the strategy, the
meta-optimizers, recompute and the topology names. ``fleet.init``,
``distributed_model``, ``distributed_optimizer``, the worker queries
and ``HybridParallelOptimizer`` come with the Fleet hybrid-training
slice and raise."""

from ...ops._common import not_ported
from ..topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group,
)
from . import distributed_strategy, meta_optimizers, utils  # noqa: F401
from . import recompute as _recompute_mod  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401

_LATER = ("init", "distributed_model", "distributed_optimizer",
          "worker_index", "worker_num", "is_first_worker", "barrier_worker",
          "fleet_base", "hybrid_optimizer", "HybridParallelOptimizer",
          "HybridParallelClipGrad")


def __getattr__(name):
    if name in _LATER:
        raise not_ported(f"fleet.{name}", "Distributed II (Fleet hybrid "
                         "training)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
