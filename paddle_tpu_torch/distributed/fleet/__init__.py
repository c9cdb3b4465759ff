"""Counterpart of ``paddle_tpu/distributed/fleet``: the strategy, the
meta-optimizers, recompute, the topology names, and the hybrid-training
facade (``init``, ``distributed_model``, ``distributed_optimizer``, the
worker queries, ``HybridParallelOptimizer``)."""

from ..topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group,
)
from . import distributed_strategy, meta_optimizers, utils  # noqa: F401
from . import recompute as _recompute_mod  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
from . import fleet_base, hybrid_optimizer  # noqa: F401
from .fleet_base import (  # noqa: F401
    barrier_worker, distributed_model, distributed_optimizer, init,
    is_first_worker, worker_index, worker_num,
)
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelOptimizer,
)
