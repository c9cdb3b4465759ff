"""``paddle_tpu_torch.distributed.communication`` — counterpart of
``paddle_tpu/distributed/communication``: the collective functions, the
point-to-point operations and the ``stream`` namespace."""

from ..collective import (  # noqa: F401
    ReduceOp, Group, new_group, all_reduce, all_gather, reduce_scatter,
    broadcast, reduce, scatter, alltoall, all_to_all, barrier,
    get_world_size, get_rank,
)
from .p2p import (  # noqa: F401
    P2POp, batch_isend_irecv, isend, irecv, send, recv, P2PTask,
)
from . import stream  # noqa: F401
