"""``paddle_tpu_torch.resilience`` — counterpart of
``paddle_tpu/resilience``: the fault-tolerant training runtime.

Checkpoint layout (:mod:`.durable`), the reference's::

    <root>/
      .tmp_step_<N>/        # staging dir while a save is in flight
      step_<N>/             # committed checkpoint (atomic dir rename)
        0_0.distcp.npz      # shard payload (per-file CRC32 in metadata)
        0_0.distcp.dtypes
        0_0.metadata        # written last: the rank-local commit point
      LATEST                # text marker "step_<N>", atomically replaced

Pieces:

* :mod:`.durable`: ``save_checkpoint``, ``async_save_checkpoint``,
  ``load_latest_checkpoint``, ``restore_train_state``,
  ``gc_checkpoints``;
* :mod:`.trainer`: ``ResilientTrainer`` (auto-resume, SIGTERM flush and
  exit, NaN rollback and replay, bounded step retry);
* :mod:`.faults`: the deterministic ``FaultInjector`` (the fleet
  router's replica events too);
* :mod:`.metrics`: counters and the save-latency histogram, Prometheus
  text.
"""

from .durable import (  # noqa: F401
    async_save_checkpoint, checkpoint_path, gc_checkpoints, latest_step,
    list_checkpoints, load_latest_checkpoint, restore_train_state,
    save_checkpoint,
)
from .faults import ChaosError, Fault, FaultInjector  # noqa: F401
from .metrics import ResilienceMetrics  # noqa: F401
from .trainer import (  # noqa: F401
    Preempted, ResilienceConfig, ResilientTrainer, TrainingAborted,
)
