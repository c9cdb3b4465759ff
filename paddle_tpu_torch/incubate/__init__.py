"""Counterpart of ``paddle_tpu/incubate``."""
