"""Counterpart of ``paddle_tpu/incubate/distributed``: the MoE package."""

from . import models  # noqa: F401
