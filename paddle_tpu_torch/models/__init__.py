"""Models (counterpart of ``paddle_tpu/models``)."""

from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny  # noqa: F401
