"""Layers and functions (counterpart of ``paddle_tpu/nn``), as far as
the port has them: the ``Layer`` base and its containers, ``Linear``,
``LayerNorm``, ``RMSNorm`` and ``ReLU``, and ``functional``."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import (  # noqa: F401
    HookRemoveHelper, Layer, LayerList, ParameterList, Sequential,
)
from .common_layers import LayerNorm, Linear, ReLU, RMSNorm  # noqa: F401
