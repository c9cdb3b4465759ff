"""Counterpart of ``paddle_tpu/distributed/fleet/utils``: sequence
parallelism, mixed precision, the fused gradient buffers and the
hybrid-parallel gradient and parameter sync, with ``recompute``."""

from . import sequence_parallel_utils  # noqa: F401
from . import mix_precision_utils  # noqa: F401
from . import tensor_fusion_helper  # noqa: F401
from . import hybrid_parallel_util  # noqa: F401

# reference import path: paddle.distributed.fleet.utils.recompute
from ..recompute import recompute, recompute_sequential  # noqa: E402,F401
