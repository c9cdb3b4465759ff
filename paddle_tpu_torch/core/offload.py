"""Host-memory offload — counterpart of ``paddle_tpu/core/offload.py``.

* :func:`offload_to_host` copies a card tensor into pinned host memory
  (a host tensor is copied on the host), and a Tensor's value is rebound
  to the copy, freeing its card memory once nothing else holds it;
* :func:`reload_to_device` copies it back (to the current place, or to
  the device given as ``sharding``);
* :func:`offload_checkpoint_policy` is the activation-offload form of
  recompute: a context whose saved-tensors hooks move every tensor the
  autograd graph saves for the backward into pinned host memory, and
  back when the backward needs it (the reference returns a
  ``jax.checkpoint`` policy that offloads matmul results).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .place import current_place
from .tensor import Tensor


def _host_copy(v: torch.Tensor) -> torch.Tensor:
    v = v.detach()
    if v.is_cuda:
        out = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        out.copy_(v)
        return out
    return v.clone()


def offload_to_host(x):
    """Move an array/Tensor to host memory (module docstring)."""
    v = x._value if isinstance(x, Tensor) else x
    out = _host_copy(torch.as_tensor(v))
    if isinstance(x, Tensor):
        x._value = out
        return x
    return out


def reload_to_device(x, sharding: Optional[Any] = None):
    """Bring an offloaded array back to the device: ``sharding`` names a
    torch device, the current place's when None."""
    v = x._value if isinstance(x, Tensor) else x
    dev = (torch.device(sharding) if sharding is not None
           else current_place().torch_device())
    out = v.to(dev, non_blocking=v.is_pinned())
    if isinstance(x, Tensor):
        x._value = out
        return x
    return out


def offload_checkpoint_policy():
    """A context manager: inside it, the tensors autograd saves for the
    backward live in (pinned) host memory between the forward and the
    backward."""
    def pack(t: torch.Tensor):
        return t.device, _host_copy(t)

    def unpack(packed):
        device, host = packed
        return host.to(device, non_blocking=host.is_pinned())

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)
