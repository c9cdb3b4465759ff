"""Kernels and their plain PyTorch versions (counterpart of ``paddle_tpu/ops``)."""
