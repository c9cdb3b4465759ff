"""Optimizers (counterpart of ``paddle_tpu/optimizer``): the families,
gradient clipping and the learning-rate schedulers, with the JAX
package's exports."""

from .optimizer import (  # noqa: F401
    Optimizer, SGD, Momentum, Adam, Adamax, Lamb, RMSProp, Adagrad,
)
from .adamw import AdamW  # noqa: F401
from .clip import ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm  # noqa: F401
from . import lr  # noqa: F401
