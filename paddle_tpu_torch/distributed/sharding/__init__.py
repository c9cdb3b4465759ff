"""``paddle_tpu_torch.distributed.sharding`` — ZeRO group-sharded data
parallelism, counterpart of ``paddle_tpu/distributed/sharding``: stage 1
(``"os"``) splits the optimizer state over the group, stage 2
(``"os_g"``) the gradients too, stage 3 (``"p_g_os"``) the parameters
too. Each rank holds its slab and the collectives are explicit
(``group_sharded.py``)."""

from .group_sharded import (  # noqa: F401
    GroupShardedOptimizerStage2,
    GroupShardedStage2,
    GroupShardedStage3,
    group_sharded_parallel,
    save_group_sharded_model,
    shard_spec_for,
)
