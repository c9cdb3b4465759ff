"""Counterpart of ``paddle_tpu/distributed/meta_parallel``."""
