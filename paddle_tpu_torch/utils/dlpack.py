"""Zero-copy tensor interchange — counterpart of
``paddle_tpu/utils/dlpack.py`` over ``torch.utils.dlpack``."""

from __future__ import annotations

import torch
import torch.utils.dlpack as _tdl

from ..core.tensor import Tensor

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """Tensor → an object speaking the DLPack protocol (``__dlpack__``,
    ``__dlpack_device__``), which every consumer's ``from_dlpack`` takes;
    the reference hands back the same kind of carrier."""
    if isinstance(x, Tensor):
        return x._value.detach()
    return torch.as_tensor(x)


def from_dlpack(dlpack):
    """Any object speaking the DLPack protocol (a torch tensor, a numpy
    array, ``to_dlpack``'s output) → Tensor, sharing its memory where it
    lives."""
    if not hasattr(dlpack, "__dlpack__"):
        raise TypeError(
            "from_dlpack needs an object with __dlpack__ (torch tensor, "
            "numpy array, paddle to_dlpack output); raw legacy capsules "
            "are not taken")
    return Tensor(_tdl.from_dlpack(dlpack))
