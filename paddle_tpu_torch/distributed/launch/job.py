"""Launch jobs — counterpart of ``paddle_tpu/distributed/launch/job.py``,
the part ``spawn`` uses: :func:`build_trainer_env`, the ``PADDLE_*``
contract of every trainer process. ``Status``, ``Container``, ``Pod``
and ``Job`` come with the launcher (the context-parallelism, MoE and
launch slice) and raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...ops._common import not_ported

_LATER = ("Status", "Container", "Pod", "Job")


def build_trainer_env(rank: int, world: int, local_rank: int, local_size: int,
                      endpoint: str, all_endpoints: List[str], master: str,
                      node_rank: int = 0, job_id: str = "default",
                      restart_count: int = 0,
                      device: Optional[str] = None) -> Dict[str, str]:
    """The PADDLE_* env every trainer process receives — shared by the
    launch CLI and ``spawn`` so the two cannot drift."""
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(local_size),
        "PADDLE_NODE_RANK": str(node_rank),
        "PADDLE_CURRENT_ENDPOINT": endpoint,
        "PADDLE_TRAINER_ENDPOINTS": ",".join(all_endpoints),
        "PADDLE_MASTER": master,
        "PADDLE_JOB_ID": job_id,
        "PADDLE_RESTART_COUNT": str(restart_count),
        "FLAGS_selected_devices": device if device is not None else str(local_rank),
    }


def __getattr__(name):
    if name in _LATER:
        raise not_ported(f"launch.job.{name} (the launch CLI)",
                         "Distributed III")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
