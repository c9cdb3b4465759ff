"""``paddle_tpu_torch.device`` — device query/control namespace,
counterpart of ``paddle_tpu/device.py``.

The devices are torch's: the host and the CUDA cards. Stated
difference: ``is_compiled_with_cuda()`` is True here (the JAX package's
answer is False). ``cuda`` is the card namespace (device count, name,
capability, memory counters, ``synchronize``, ``empty_cache``) over
``torch.cuda``; ``xpu`` answers as a build without XPUs does.
"""

from __future__ import annotations

import types

import torch

from .core.place import current_place, set_device, get_device  # noqa: F401

__all__ = [
    "set_device", "get_device", "get_all_device_type",
    "get_available_device", "get_device_count", "device_count",
    "synchronize", "is_compiled_with_cuda", "is_compiled_with_rocm",
    "is_compiled_with_xpu", "is_compiled_with_distribute",
    "cuda", "xpu",
]


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_available_device():
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_device_count() -> int:
    return torch.cuda.device_count()


device_count = get_device_count


def synchronize(device=None):
    """Block until the work queued on the card finishes."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return True


def _cuda_ns() -> types.ModuleType:
    m = types.ModuleType(f"{__name__}.cuda")
    m.device_count = torch.cuda.device_count
    m.current_device = torch.cuda.current_device
    m.get_device_name = lambda device=None: torch.cuda.get_device_name(device)
    m.get_device_capability = \
        lambda device=None: torch.cuda.get_device_capability(device)
    m.synchronize = lambda device=None: torch.cuda.synchronize(device)
    m.empty_cache = torch.cuda.empty_cache
    m.max_memory_allocated = \
        lambda device=None: torch.cuda.max_memory_allocated(device)
    m.max_memory_reserved = \
        lambda device=None: torch.cuda.max_memory_reserved(device)
    m.memory_allocated = lambda device=None: torch.cuda.memory_allocated(device)
    m.memory_reserved = lambda device=None: torch.cuda.memory_reserved(device)
    return m


def _stub_ns(name: str) -> types.ModuleType:
    m = types.ModuleType(f"{__name__}.{name}")
    m.device_count = lambda: 0
    m.current_device = lambda: None
    m.get_device_name = lambda device=None: None
    m.get_device_capability = lambda device=None: None
    m.synchronize = lambda device=None: None
    m.empty_cache = lambda: None
    m.max_memory_allocated = lambda device=None: 0
    m.max_memory_reserved = lambda device=None: 0
    m.memory_allocated = lambda device=None: 0
    m.memory_reserved = lambda device=None: 0
    return m


#: paddle.device.cuda over torch.cuda; paddle.device.xpu: no devices
cuda = _cuda_ns()
xpu = _stub_ns("xpu")
