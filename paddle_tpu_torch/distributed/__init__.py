"""Counterpart of ``paddle_tpu/distributed``: the one-device layers and
the optimizer wrappers of main-grad training."""
