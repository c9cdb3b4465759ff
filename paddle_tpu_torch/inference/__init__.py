"""Serving engine and token selection (counterpart of ``paddle_tpu/inference``)."""
