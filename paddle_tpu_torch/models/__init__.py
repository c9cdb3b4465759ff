"""Models (counterpart of ``paddle_tpu/models``)."""

from . import ernie, gpt, llama  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny  # noqa: F401
