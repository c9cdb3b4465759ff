"""Functional bridge between Layers and their tensors — counterpart of
``paddle_tpu/jit/functional.py``.

The reference lifts a Layer's parameters and buffers out as jax arrays
and rebinds them to traced values while ``jax.jit`` traces the forward.
A port Layer is a ``torch.nn.Module`` whose parameters are torch leaves:
a compiled program (a CUDA graph) reads them where they live and the
train step updates them in place, so nothing needs rebinding on the
compiled path. :func:`bind` and :func:`functional_call` still give the
reference's surface: call a layer with other tensors substituted for its
parameters and buffers, and get back the buffers it rebound.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..core.tensor import Tensor

__all__ = ["param_arrays", "buffer_arrays", "bind", "functional_call",
           "tree_wrap", "tree_unwrap"]


def param_arrays(layer, trainable_only: bool = False) -> Dict[str, Any]:
    """``{structured name: parameter}`` (the live torch leaves)."""
    out = {}
    for name, p in layer.named_parameters():
        if trainable_only and not getattr(p, "trainable", p.requires_grad):
            continue
        out[name] = p
    return out


def buffer_arrays(layer) -> Dict[str, Any]:
    return {n: b for n, b in layer.named_buffers() if b is not None}


def _slots(layer, kind: str) -> Dict[str, tuple]:
    """``{structured name: (owning module, attribute)}`` of the layer's
    parameters (``kind="_parameters"``) or buffers."""
    out = {}
    for prefix, m in layer.named_modules(remove_duplicate=False):
        for n, v in getattr(m, kind).items():
            if v is not None:
                out.setdefault(f"{prefix}.{n}" if prefix else n, (m, n))
    return out


@contextlib.contextmanager
def bind(layer, params: Dict[str, Any] = None,
         buffers: Dict[str, Any] = None):
    """Temporarily point the layer's parameters and buffers at the given
    tensors (Tensors or torch tensors); on exit restore the originals
    and their gradients, and fill the yielded dict with each buffer's
    value as the call left it."""
    pslots, bslots = _slots(layer, "_parameters"), _slots(layer, "_buffers")
    saved_p = {n: m._parameters[a] for n, (m, a) in pslots.items()}
    saved_b = {n: m._buffers[a] for n, (m, a) in bslots.items()}
    saved_g = {n: p.grad for n, p in saved_p.items()}
    mutated: Dict[str, Any] = {}
    try:
        for n, v in (params or {}).items():
            if n in pslots:
                m, a = pslots[n]
                m._parameters[a] = v._value if isinstance(v, Tensor) else v
        for n, v in (buffers or {}).items():
            if n in bslots:
                m, a = bslots[n]
                m._buffers[a] = v._value if isinstance(v, Tensor) else v
        yield mutated
    finally:
        for n, (m, a) in bslots.items():
            mutated[n] = m._buffers[a]
            m._buffers[a] = saved_b[n]
        for n, (m, a) in pslots.items():
            m._parameters[a] = saved_p[n]
            saved_p[n].grad = saved_g[n]


def functional_call(layer, params: Dict[str, Any], *args,
                    buffers: Dict[str, Any] = None, **kwargs):
    """Call ``layer`` with parameters substituted from ``params``.
    Returns ``(output, new_buffers)``."""
    with bind(layer, params, buffers) as mutated:
        out = layer(*args, **kwargs)
    return out, mutated


def tree_unwrap(x):
    """Tensors as torch tensors, inside lists, tuples and dicts."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)):
        return type(x)(tree_unwrap(e) for e in x)
    if isinstance(x, dict):
        return {k: tree_unwrap(v) for k, v in x.items()}
    return x


def tree_wrap(x):
    """torch tensors as Tensors, inside lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x, not x.requires_grad)
    if isinstance(x, (list, tuple)):
        return type(x)(tree_wrap(e) for e in x)
    if isinstance(x, dict):
        return {k: tree_wrap(v) for k, v in x.items()}
    return x
