"""Counterpart of ``paddle_tpu/incubate/nn``: the fused layers and the
fused functional surface. ``FusedMultiTransformerInt8`` comes with the
quantization slice."""

from .layer.fused_transformer import (  # noqa: F401
    FusedMultiTransformer, FusedMultiHeadAttention, FusedFeedForward,
)
from . import functional  # noqa: F401
