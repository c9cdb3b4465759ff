"""Counterpart of ``paddle_tpu/parallel``: the process mesh (``mesh``)
and the manual-parallel context (``pcontext``). The compiled pipeline
schedules (``pipeline``) come with the Fleet hybrid-training slice."""

from . import mesh, pcontext  # noqa: F401
