"""Models (counterpart of ``paddle_tpu/models``)."""
