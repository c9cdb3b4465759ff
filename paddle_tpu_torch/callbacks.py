"""``paddle_tpu_torch.callbacks`` — the hapi callbacks at the top-level
path, as ``paddle_tpu/callbacks.py`` re-exports them."""

from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau, VisualDL,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "VisualDL"]
