"""Device identity ("Place") — counterpart of ``paddle_tpu/core/place.py``.

A Place names a torch device: ``CUDAPlace(i)`` is ``cuda:i`` and
``CPUPlace`` the host. ``TPUPlace`` (``XLAPlace``) is accepted as a name
but holds no tensor: the port has no TPU.

Two stated differences from the JAX package:

* the default place is ``CUDAPlace(0)``, where the reference falls back
  to the CPU when it finds no accelerator (``_default_place``). Without
  a card the first tensor made on the default place raises, and the
  message names ``set_device("cpu")``;
* ``Tensor.place`` is where the tensor's storage lives; the reference
  returns the current place whatever the tensor.
"""

from __future__ import annotations

import functools

import torch


class Place:
    """Base device identity. Equality is by (kind, index)."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (
            isinstance(other, Place)
            and self.kind == other.kind
            and self._device_id == other._device_id
        )

    def __hash__(self):
        return hash((self.kind, self._device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self._device_id})"

    def torch_device(self) -> torch.device:
        raise RuntimeError(f"{self!r} holds no tensor in the PyTorch port")


class CPUPlace(Place):
    kind = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class TPUPlace(Place):
    kind = "tpu"


# The JAX package's name for its accelerator place.
XLAPlace = TPUPlace


class CUDAPlace(Place):
    """The card ``cuda:<device_id>``."""

    kind = "gpu"

    def torch_device(self) -> torch.device:
        if not _cuda_available():
            raise RuntimeError(
                "no CUDA device is available for the default place "
                "CUDAPlace(0); call paddle_tpu_torch.set_device('cpu') to "
                "run on the host")
        return torch.device("cuda", self._device_id)


@functools.lru_cache(maxsize=None)
def _cuda_available() -> bool:
    return torch.cuda.is_available()


_current_place: list = [None]


def _default_place() -> Place:
    return CUDAPlace(0)


def set_device(device: str) -> Place:
    """``set_device("gpu")`` / ``"gpu:1"`` / ``"cuda:0"`` / ``"cpu"``
    (``"tpu"``/``"xla"`` name a place that holds no tensor here)."""
    name, _, idx = device.partition(":")
    idx = int(idx) if idx else 0
    cls = {"cpu": CPUPlace, "tpu": TPUPlace, "xla": TPUPlace,
           "gpu": CUDAPlace, "cuda": CUDAPlace}.get(name)
    if cls is None:
        raise ValueError(f"Unknown device {device!r}")
    _current_place[0] = cls(idx)
    return _current_place[0]


def get_device() -> str:
    p = _current_place[0] or _default_place()
    return f"{p.kind}:{p.get_device_id()}"


def current_place() -> Place:
    return _current_place[0] or _default_place()


def place_of(device: torch.device) -> Place:
    """The Place a torch device is."""
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    return CPUPlace(0)


def is_compiled_with_tpu() -> bool:
    return False
