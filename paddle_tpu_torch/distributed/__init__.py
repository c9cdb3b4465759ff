"""Counterpart of ``paddle_tpu/distributed``: the collective API over
``torch.distributed`` (a rank is a process: gloo for CPU tensors, NCCL
for CUDA tensors), point-to-point communication, the rendezvous store,
``spawn``, the topology, the RNG tracker, recompute and the
meta-optimizers (``fleet``), and one-process checkpoints.

``sharding`` and ``fleet``'s hybrid engine come with the Fleet
hybrid-training slice; ``auto_parallel`` (``shard_tensor``,
``ProcessMesh``, ...) and the launch CLI with the context-parallelism,
MoE and launch slice. Those names raise.
"""

from .env import (  # noqa: F401
    init_parallel_env, ParallelEnv, is_initialized,
)
from .collective import (  # noqa: F401
    ReduceOp, Group, new_group, all_reduce, all_gather, reduce_scatter,
    broadcast, reduce, scatter, alltoall, all_to_all, send, recv, barrier,
    gather, wait, get_backend, destroy_process_group, all_gather_object,
    broadcast_object_list, scatter_object_list, get_rank, get_world_size,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from . import collective, topology, store  # noqa: F401
from . import fleet  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import save_state_dict, load_state_dict  # noqa: F401
from . import env  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import launch  # noqa: F401
from . import communication  # noqa: F401
from .communication.p2p import (  # noqa: F401
    P2POp, batch_isend_irecv, isend, irecv,
)
from .communication import stream  # noqa: F401

_ITEM2 = "Distributed II (Fleet hybrid training)"
_ITEM4 = ("Distributed IV (tensor-parallel serving, elastic resize, "
          "auto_parallel)")
_LATER = dict.fromkeys(
    ("auto_parallel", "shard_tensor", "ProcessMesh", "Shard", "Replicate",
     "Partial", "reshard", "shard_layer", "dtensor_from_fn", "Strategy"),
    _ITEM4)
_LATER["sharding"] = _ITEM2


def __getattr__(name):
    if name in _LATER:
        from ..ops._common import not_ported
        raise not_ported(f"paddle_tpu_torch.distributed.{name}",
                         _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
