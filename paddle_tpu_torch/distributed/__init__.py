"""Counterpart of ``paddle_tpu/distributed``: the collective API over
``torch.distributed`` (a rank is a process: gloo for CPU tensors, NCCL
for CUDA tensors), point-to-point communication, the rendezvous store,
``spawn``, the topology, the RNG tracker, recompute and the
meta-optimizers (``fleet``), ``sharding``, one-process checkpoints, the
launch CLI and ``auto_parallel`` (``ProcessMesh``, ``shard_tensor``,
``reshard``, ``shard_layer``, ``Engine``: each rank holds its slab of a
distributed tensor).
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
from . import sharding  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import save_state_dict, load_state_dict  # noqa: F401
from . import env  # noqa: F401
from .auto_parallel.api import (  # noqa: F401
    shard_tensor, ProcessMesh, Shard, Replicate, Partial, reshard,
    shard_layer, dtensor_from_fn, Strategy,
)
from .spawn import spawn  # noqa: F401
from . import launch  # noqa: F401
from . import communication  # noqa: F401
from .communication.p2p import (  # noqa: F401
    P2POp, batch_isend_irecv, isend, irecv,
)
from .communication import stream  # noqa: F401
