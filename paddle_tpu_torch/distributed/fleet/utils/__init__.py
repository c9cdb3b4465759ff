"""Counterpart of ``paddle_tpu/distributed/fleet/utils``: ``recompute``
and ``mix_precision_utils``. ``sequence_parallel_utils``,
``hybrid_parallel_util`` and ``tensor_fusion_helper`` come with the
Fleet hybrid-training slice."""

from . import mix_precision_utils  # noqa: F401

# reference import path: paddle.distributed.fleet.utils.recompute
from ..recompute import recompute, recompute_sequential  # noqa: E402,F401
