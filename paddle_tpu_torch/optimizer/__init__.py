"""Optimizers (counterpart of ``paddle_tpu/optimizer``)."""
