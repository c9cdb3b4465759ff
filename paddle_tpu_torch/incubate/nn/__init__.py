"""Counterpart of ``paddle_tpu/incubate/nn``: the fused layers and the
fused functional surface."""

from .layer.fused_transformer import (  # noqa: F401
    FusedMultiTransformer, FusedMultiHeadAttention, FusedFeedForward,
    FusedMultiTransformerInt8,
)
from . import functional  # noqa: F401
