"""``nn.utils`` — counterpart of ``paddle_tpu/nn/utils.py``: the
``weight_norm`` / ``remove_weight_norm`` and ``spectral_norm``
reparametrizations (forward pre-hooks that rebuild the weight each
call), ``clip_grad_norm_`` / ``clip_grad_value_``, and
``parameters_to_vector`` / ``vector_to_parameters``.

The parameters these make (``<name>_v`` and ``<name>_g``, the folded
weight) are made by ``paddle.create_parameter`` as the reference's are,
so they take the same keys from the stream; the derived weight is a
plain attribute the layer's ``forward`` reads, carrying the gradient to
the parameters it is built from.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.tensor import Tensor
from .layer import Layer

__all__ = [
    "weight_norm", "remove_weight_norm", "spectral_norm",
    "clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
    "vector_to_parameters",
]


def _raw(p):
    return p._value if isinstance(p, Tensor) else p


def _norm_except(v, dim):
    """||v|| over every axis except ``dim`` (kept), or over all."""
    if dim is None:
        return torch.sqrt((v * v).sum())
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt((v * v).sum(dim=axes, keepdim=True))


def _new_parameter(value: torch.Tensor):
    """A parameter holding ``value``, made by ``create_parameter`` (the
    reference's key draw included)."""
    from ..creation import create_parameter
    p = create_parameter(list(value.shape), value.dtype)
    p._value.data.copy_(value.to(p._value.device))
    return p


def weight_norm(layer: Layer, name: str = "weight", dim: int = 0):
    """Reparametrize ``layer.<name>`` as ``g · v / ||v||``: ``<name>_v``
    and ``<name>_g`` become the trainable parameters and a forward
    pre-hook rebuilds the weight before each call."""
    w = getattr(layer, name)
    if w is None:
        raise ValueError(f"layer has no parameter {name!r}")
    wv = _raw(w).detach()
    setattr(layer, f"{name}_v", _new_parameter(wv))
    setattr(layer, f"{name}_g", _new_parameter(_norm_except(wv, dim)))
    w.trainable = False
    w.requires_grad_(False)
    layer._parameters.pop(name, None)
    layer.__dict__[name] = w
    axes = None if dim is None else tuple(
        i for i in range(wv.dim()) if i != dim)

    def hook(lyr, inputs):
        vv = getattr(lyr, f"{name}_v")
        gg = getattr(lyr, f"{name}_g")
        sq = (vv * vv).sum() if axes is None else \
            (vv * vv).sum(dim=axes, keepdim=True)
        lyr.__dict__[name] = gg * vv / sq.sqrt().clamp_min(1e-12)
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer.__dict__.setdefault("_weight_norm_hooks", {})[name] = (handle, dim)
    hook(layer, ())
    return layer


def remove_weight_norm(layer: Layer, name: str = "weight"):
    """Fold ``g · v / ||v||`` back into a plain parameter and drop the
    hook."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"{name!r} is not weight-normed on this layer")
    handle, dim = hooks.pop(name)
    handle.remove()
    v = getattr(layer, f"{name}_v").detach()
    g = getattr(layer, f"{name}_g").detach()
    folded = g * v / torch.clamp_min(_norm_except(v, dim), 1e-12)
    layer.__dict__.pop(name, None)
    setattr(layer, name, _new_parameter(folded))
    for suffix in ("_v", "_g"):
        layer._parameters.pop(f"{name}{suffix}", None)
    return layer


def spectral_norm(layer: Layer, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0):
    """Divide ``layer.<name>`` by its largest singular value, estimated
    by power iteration refreshed on every forward; the original stays
    the trainable parameter as ``<name>_orig``."""
    w = getattr(layer, name)
    mat = _raw(w).detach()
    if dim != 0:
        mat = mat.permute((dim,) + tuple(i for i in range(mat.dim())
                                         if i != dim))
    rng = np.random.RandomState(0)
    state = {"u": torch.as_tensor(rng.randn(mat.shape[0]).astype(np.float32),
                                  device=mat.device)}
    layer._parameters.pop(name, None)
    layer._parameters[f"{name}_orig"] = w

    def hook(lyr, inputs):
        worig = getattr(lyr, f"{name}_orig")
        with torch.no_grad():
            m = worig.detach()
            if dim != 0:
                m = m.permute((dim,) + tuple(i for i in range(m.dim())
                                             if i != dim))
            m2 = m.reshape(m.shape[0], -1)
            u = state["u"]
            vvec = m2.T @ u
            vvec = vvec / torch.clamp_min(torch.linalg.vector_norm(vvec), eps)
            for _ in range(n_power_iterations):
                u = m2 @ vvec
                u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
                vvec = m2.T @ u
                vvec = vvec / torch.clamp_min(torch.linalg.vector_norm(vvec),
                                              eps)
            state["u"] = u
            sigma = torch.clamp_min(u @ m2 @ vvec, eps)
        lyr.__dict__[name] = worig / sigma
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer.__dict__.setdefault("_spectral_norm_hooks", {})[name] = handle
    hook(layer, ())
    return layer


def _grad_holders(parameters):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    return [_raw(p) for p in params if _raw(p).grad is not None]


def clip_grad_norm_(parameters, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """Scale the gradients of ``parameters`` in place so their global
    ``norm_type`` norm is at most ``max_norm``; returns the norm before
    clipping."""
    params = _grad_holders(parameters)
    if not params:
        return Tensor(torch.zeros(()))
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = sum((g.float().abs() ** norm_type).sum()
                    for g in grads) ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite gradient norm")
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-6), 1.0)
    for p in params:
        p.grad = (p.grad.float() * scale).to(p.grad.dtype)
    return Tensor(total)


def clip_grad_value_(parameters, clip_value: float):
    """Clamp every gradient to ``[-clip_value, clip_value]`` in place."""
    for p in _grad_holders(parameters):
        p.grad = torch.clamp(p.grad, -clip_value, clip_value)


def parameters_to_vector(parameters) -> Tensor:
    """The parameters flattened into one 1-D tensor, in order."""
    vals = [_raw(p).detach().reshape(-1) for p in parameters]
    return Tensor(torch.cat(vals) if vals else torch.zeros((0,)))


def vector_to_parameters(vec: Tensor, parameters: List):
    """Write consecutive slices of ``vec`` into the parameters, in
    order."""
    v = _raw(vec) if isinstance(vec, (Tensor, torch.Tensor)) \
        else torch.as_tensor(np.asarray(vec))
    params = list(parameters)
    total = sum(int(np.prod(p.shape)) if len(p.shape) else 1
                for p in params)
    if total != v.shape[0]:
        raise ValueError(f"vector length {v.shape[0]} != total parameter "
                         f"size {total}")
    at = 0
    with torch.no_grad():
        for p in params:
            n = int(np.prod(p.shape)) if len(p.shape) else 1
            t = _raw(p)
            t.copy_(v[at:at + n].reshape(tuple(t.shape)).to(t.dtype))
            at += n
