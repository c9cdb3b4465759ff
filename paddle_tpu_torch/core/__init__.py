"""Subsystem-neutral building blocks (counterpart of ``paddle_tpu/core``;
only ``histogram`` is ported so far)."""
