"""Serving engines, their compiled programs and the decoding options
(counterpart of ``paddle_tpu/inference``)."""

from .decoding import (  # noqa: F401
    ContinuousBatchingEngine, GenerationConfig, GenerationEngine, KVCache,
    PagedGenerationEngine, llama_engine,
)
