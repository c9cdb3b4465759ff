"""Layers and functions (counterpart of ``paddle_tpu/nn``), as far as
the ported models use them."""
