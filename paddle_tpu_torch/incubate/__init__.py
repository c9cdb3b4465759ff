"""Counterpart of ``paddle_tpu/incubate``: the fused layers (``nn``),
the MoE package (``distributed``) and functional higher-order autograd
(``autograd``)."""

from . import autograd  # noqa: F401
from . import distributed  # noqa: F401
