"""``paddle_tpu_torch.resilience`` — counterpart of
``paddle_tpu/resilience``. Ported: :mod:`.faults` (``Fault``,
``FaultInjector``, ``ChaosError``), the chaos surface the fleet router
fires. Not ported yet: ``durable`` (checkpoints), ``trainer``
(``ResilientTrainer``) and ``metrics``.
"""

from .faults import ChaosError, Fault, FaultInjector  # noqa: F401

__all__ = ["ChaosError", "Fault", "FaultInjector"]
