"""``paddle.save`` / ``paddle.load`` — counterpart of
``paddle_tpu/framework/io_save.py``: an object is pickled with each
Tensor (or torch tensor) as a :class:`_TensorPayload` (dtype name, shape
and raw bytes; a bfloat16 one as its ``uint16`` bits under
``"bfloat16"``), the reference's format. A file the reference saved
loads here: its payloads, pickled as
``paddle_tpu.framework.io_save._TensorPayload``, unpickle as this
module's without importing the JAX package. ``load`` gives Tensors on
the current place."""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core.tensor import Tensor, to_torch as _to_place
from ..distributed.checkpoint.utils import BF16, to_array, to_torch

_REFERENCE = "paddle_tpu.framework.io_save"


class _TensorPayload:
    """Pickle-stable tensor container (dtype name + raw bytes + shape)."""

    def __init__(self, arr):
        a, self.dtype = to_array(arr)
        self.shape = a.shape
        self.data = a.tobytes()

    def to_numpy(self):
        """The array (a bfloat16 one as float32: numpy has no
        bfloat16)."""
        if self.dtype == BF16:
            return self.to_torch().float().numpy()
        return np.frombuffer(self.data, dtype=np.dtype(self.dtype)
                             ).reshape(self.shape)

    def to_torch(self) -> torch.Tensor:
        raw = np.frombuffer(self.data, dtype=np.uint16 if self.dtype == BF16
                            else np.dtype(self.dtype)).reshape(self.shape)
        return to_torch(raw.copy(), self.dtype)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _REFERENCE and name == "_TensorPayload":
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj):
    if isinstance(obj, _TensorPayload):
        return Tensor(_to_place(obj.to_torch()))
    if isinstance(obj, dict):
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **kwargs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, **kwargs):
    with open(path, "rb") as f:
        return _unpack(_Unpickler(f).load())
