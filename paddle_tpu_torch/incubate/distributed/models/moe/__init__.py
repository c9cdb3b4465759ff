"""Mixture-of-Experts — counterpart of
``paddle_tpu/incubate/distributed/models/moe``: the gates, ``MoELayer``
(the gather dispatch, and the expert-parallel path over a multi-rank
``moe_group``), the expert-aware clip and ``global_scatter`` /
``global_gather``."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import MoELayer  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .utils import global_gather, global_scatter  # noqa: F401
