"""Counterpart of ``paddle_tpu/incubate``: the fused layers (``nn``) and
the MoE package (``distributed``)."""

from . import distributed  # noqa: F401
