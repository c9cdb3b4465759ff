"""Counterpart of ``paddle_tpu/parallel``: the process mesh (``mesh``),
the manual-parallel context (``pcontext``) and the pipeline schedules
over a pp group (``pipeline``)."""

from . import mesh, pcontext  # noqa: F401
