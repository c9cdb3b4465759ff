"""``Linear``, ``LayerNorm`` and ``RMSNorm`` of
``paddle_tpu/nn/common_layers.py``,
with the reference's parameter names, its ``(in, out)`` weight layout
(``y = x @ W + b``) and its initialisers (:mod:`.initializer`).

As in the reference, a layer's weights are initialised when it is built
(from torch's default generator; ``models.ernie.init`` redraws a whole
model from a seeded one), on ``device``: ``None`` means the card and
raises without one (``ops._common.resolve_device``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..ops._common import not_ported, resolve_device
from . import functional as F
from . import initializer as I


def param_attr(attr, layer: str) -> bool:
    """Whether a layer makes the parameter of a ``weight_attr`` /
    ``bias_attr`` (the reference's ``create_parameter``): ``None`` makes
    it, ``False`` leaves it out. A ``ParamAttr`` (initializer, learning
    rate, regularizer) comes with the eager API and raises."""
    if attr is None:
        return True
    if attr is False:
        return False
    raise not_ported(f"{layer} with a ParamAttr", "eager API")


def _maybe(make: bool, shape, kw):
    return nn.Parameter(torch.empty(shape, **kw)) if make else None


class Linear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.weight = _maybe(param_attr(weight_attr, "Linear"),
                             (in_features, out_features), kw)
        self.bias = _maybe(param_attr(bias_attr, "Linear"),
                           (out_features,), kw)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.xavier_uniform_(self.weight, gen)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self._shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                       else tuple(normalized_shape))
        self._epsilon = epsilon
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.weight = _maybe(param_attr(weight_attr, "LayerNorm"),
                             self._shape, kw)
        self.bias = _maybe(param_attr(bias_attr, "LayerNorm"),
                           self._shape, kw)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.constant_(self.weight, 1.0)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.layer_norm(x, self._shape, self.weight, self.bias,
                            self._epsilon)


class RMSNorm(nn.Module):
    """Llama's RMSNorm (l.236): a scale initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, dtype=torch.float32, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = _maybe(param_attr(weight_attr, "RMSNorm"),
                             (hidden_size,),
                             dict(dtype=dtype, device=resolve_device(device)))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.constant_(self.weight, 1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


def init_layers(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``model`` in place, seeded: each layer's
    ``reset_parameters`` draws from the reference initialisers'
    distributions with one ``torch.Generator`` on the parameters'
    device. Returns ``model``."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 from JAX included) as a CPU
    tensor of its own memory."""
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_layer_state(model: nn.Module, np_state: Dict[str, Any]) -> None:
    """Copy weights into ``model`` by name: ``np_state`` maps the JAX
    model's ``named_parameters()`` names to arrays (e.g. ``np.asarray``
    of each ``p._value``). Every parameter must be given, with its
    shape, and no other name; values are cast to the parameter's
    dtype."""
    own = dict(model.named_parameters())
    if set(own) != set(np_state):
        raise ValueError(
            f"names differ: missing {sorted(set(own) - set(np_state))}, "
            f"unknown {sorted(set(np_state) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            t = to_tensor(np.asarray(np_state[name]))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
