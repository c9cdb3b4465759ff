"""Serving engines, their compiled programs and the decoding options
(counterpart of ``paddle_tpu/inference``)."""
