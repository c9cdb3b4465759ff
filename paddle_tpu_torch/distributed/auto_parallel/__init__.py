"""Auto-parallel — counterpart of ``paddle_tpu/distributed/auto_parallel``."""

from .api import ProcessMesh, Shard, Replicate, Partial, shard_tensor, reshard, dtensor_from_fn  # noqa: F401
from .engine import Engine, shard_layer  # noqa: F401
